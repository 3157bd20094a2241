"""Device-resident streaming replay: chunked ingest with on-device state.

SURVEY.md §5.7 defines streaming as the sequence-scaling axis: chunked,
double-buffered device ingest with no host round-trips.  This module keeps the
WHOLE streaming state machine on device — decode, sweep segmentation,
correction, and the (sums, counts) intensity accumulators — as one jitted
step with donated state, so an unbounded byte stream is processed at device
speed with only the raw chunks crossing to the device.

Exact-parity semantics (same invariants as the host ``StreamingSession``):

  * byte carry — by the >=11-byte start-spacing theorem (ops/decode.py),
    positions with a full 11-byte window are accepted or rejected
    definitively and interior positions of an accepted frame can never
    validate, so overlapping consecutive chunk windows by exactly 10 bytes
    loses no frame and double-counts none;
  * frame carry — a row's correction depends on every baseline in its sweep
    group, so the open (last) group's frames stay in a device carry buffer
    until a UE-decrease boundary closes them; closed groups run through
    ``correct_rows_jax`` and fold into the accumulators.  Per-cell means
    are sum/count, hence order-independent and equal to the offline pivot.
  * ``SceneConfig.log_transform`` is honored on this path (drop RSS<=0,
    fold ln RSS), matching pivot_data's pre-log (heatmap_gemini_v1-7.py:
    108-132).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Union

import numpy as np

from slam_process_tpu.config import PipelineConfig, SceneConfig
from slam_process_tpu.ops.decode import decode_rows_jax, frame_capacity
from slam_process_tpu.ops.scene import IntensityGrid, intensity_sums_jax
from slam_process_tpu.utils import get_logger

_LOGGER = get_logger("slam_process_tpu.streaming_device")

CARRY_BYTES = 10   # frame_len - 1: the only positions without a verdict


class StreamPathsSpec(NamedTuple):
    """Hashable config for ONLINE per-sweep estimation + tracking.

    The offline flagship (``Session.sweep_paths`` / ``path_tracks``) runs
    as a batch pass over a finished session; this spec arms the streaming
    state machine to do the same work AS SWEEPS CLOSE, fully device-
    resident: when the kept-row stream shows a UE decrease, the finished
    sweep's intensity grid feeds the per-sweep estimator inside the SAME
    jitted step, and the greedy-NN tracker (models/tracking) advances its
    carry.  An unbounded stream therefore yields paths and CLK-anchored
    tracks continuously — not only grids.

    The beam set (``ue_ids``/``bs_ids``) and the dictionary derived from
    it are FIXED UP FRONT (production streaming knows its codebook; the
    offline path can be pinned to the same set via ``sweep_paths``'s
    ``beam_ids`` override, which is how the exact-parity tests compare
    the two).  ``s_step`` bounds sweeps closing per step and ``capacity``
    bounds total closed sweeps; exceeding either flags ``paths_overflow``
    and result reads raise rather than return truncated data.

    Sizing ``s_step``: every step pays the estimation block at the FULL
    static [s_step+1] lane count (per-sweep sums scan + estimator +
    tracker), so size it to the sweeps you expect to close per chunk —
    the default 64 suits ~1 MiB chunks of this dataset (up to 58 sweeps
    per chunk); a live feed with small chunks (64 KiB ~ a handful of
    sweeps) runs several times faster with ``s_step=8``.
    """

    estimator: str          # "nn_omp" | "sm_sic"
    est_key: tuple          # from sweep_estimator_setup
    ue_ids: tuple           # participating UE beam ids (ints)
    bs_ids: tuple           # participating BS beam ids
    s_step: int             # max sweeps closing per step
    capacity: int           # max total closed sweeps
    max_tracks: int
    gate_deg: float


def make_paths_spec(
    angle_file,
    estimator: str = "nn_omp",
    beam_ids=None,
    s_step: int = 64,
    capacity: int = 4096,
    max_tracks: int = 8,
    gate_deg: float = 10.0,
    **overrides,
):
    """Build (spec, dict_args) for ``DeviceStreamingSession(collect_paths=...)``.

    ``beam_ids``: optional (ue_ids, bs_ids) sequences; defaults to every
    beam with a finite angle in the mapping file.  ``overrides`` are the
    same estimator overrides ``Session.sweep_paths`` takes (max_paths,
    grid_res, beam_width, keep_rule, stop_nonpositive).  ``dict_args`` is
    the (phi_rx, phi_tx, aoa_grid, aod_grid) tuple of f32 numpy arrays to
    pass alongside the spec.
    """
    from slam_process_tpu.io.angles import load_angle_lut
    from slam_process_tpu.models.sweep_estimation import sweep_estimator_setup

    lut = load_angle_lut(angle_file)
    if beam_ids is None:
        ids = np.nonzero(np.isfinite(lut))[0]
        ue_ids, bs_ids = ids, ids
    else:
        ue_ids = np.asarray(beam_ids[0], dtype=np.int64)
        bs_ids = np.asarray(beam_ids[1], dtype=np.int64)
    d, est_key = sweep_estimator_setup(estimator, lut[ue_ids], lut[bs_ids],
                                       **overrides)
    spec = StreamPathsSpec(
        estimator=estimator, est_key=est_key,
        ue_ids=tuple(int(i) for i in ue_ids),
        bs_ids=tuple(int(i) for i in bs_ids),
        s_step=int(s_step), capacity=int(capacity),
        max_tracks=int(max_tracks), gate_deg=float(gate_deg),
    )
    dict_args = (np.asarray(d.phi_rx, np.float32),
                 np.asarray(d.phi_tx, np.float32),
                 np.asarray(d.aoa_grid, np.float32),
                 np.asarray(d.aod_grid, np.float32))
    return spec, dict_args


class PathsState(NamedTuple):
    """Device-resident online-estimation state (None when disabled)."""

    open_sums: "np.ndarray"    # [64, 64] f32 — the OPEN kept-sweep's cells
    open_counts: "np.ndarray"  # [64, 64] f32
    open_time: "np.ndarray"    # i32 CLK of the open sweep's first kept row
    #                            (-1: no open sweep yet)
    last_kept_ue: "np.ndarray" # i32 previous kept row's UE (-1: none)
    n_closed: "np.ndarray"     # i32 sweeps closed+estimated so far
    overflow: "np.ndarray"     # bool: s_step or capacity exceeded
    est_rings: object          # estimator-output pytree, leaves [Palloc, ...]
    valid_ring: "np.ndarray"   # [Palloc] bool (sweep had observed cells)
    time_ring: "np.ndarray"    # [Palloc] i32 raw CLK anchors
    trk_pos: "np.ndarray"      # [T, 2] f32 tracker carry
    trk_created: "np.ndarray"  # [T] bool
    trk_count: "np.ndarray"    # i32
    trk_aoa: "np.ndarray"      # [Palloc, T] f32 track history rings
    trk_aod: "np.ndarray"      # [Palloc, T] f32
    trk_pow: "np.ndarray"      # [Palloc, T] f32
    trk_obs: "np.ndarray"      # [Palloc, T] bool


class DeviceStreamState(NamedTuple):
    carry_frames: "np.ndarray"   # [Gcap, 5] i32 — open sweep group
    carry_count: "np.ndarray"    # scalar i32
    sums: "np.ndarray"           # [64, 64] f32 running intensity sums
    counts: "np.ndarray"         # [64, 64] f32 running cell counts
    n_frames: "np.ndarray"       # scalar i32
    n_kept: "np.ndarray"         # scalar i32
    n_groups: "np.ndarray"       # scalar i32 (closed groups)
    overflow: "np.ndarray"       # scalar bool (any static bound exceeded)
    emit_buf: "np.ndarray"       # [Ecap, 4] i32 device emit ring (ue,
    #                              corrected_bs, rss, clk); Ecap=0 when
    #                              collect_filtered is off
    emit_count: "np.ndarray"     # scalar i32 rows written to emit_buf
    emit_overflow: "np.ndarray"  # scalar bool: kept rows were dropped
    #                              because the emit ring filled — exported
    #                              `filtered` would be silently truncated,
    #                              so reading it raises instead
    paths: object                # PathsState (online estimation) or None


def _emit_kept_rows(state, combined, corrected, keep, ecap: int):
    """Append this step's kept rows to the device emit ring.

    Kept rows sort-compact to a dense prefix (the sort key is the row
    index where kept — unique and ascending, so stream order is exact),
    then ONE dynamic_update_slice block write lands them at emit_count: a
    data-dependent scatter of [t] rows becomes an in-place contiguous
    write.  The ring is allocated
    with one block of slack (see DeviceStreamingSession), so the t-row
    block never clamps: junk rows past this step's kept count are
    overwritten by the next step's block (offsets advance by exactly
    kept), and the final `[:emit_count]` read never sees them.  Keeps the
    feed loop free of device-to-host reads: the ring drains ONCE when
    ``filtered`` is consumed.

    Rows past the LOGICAL capacity ``ecap`` are dropped and flagged via
    overflow; ``emit_count`` saturates at ecap so later block writes land
    in the slack region only.
    """
    import jax
    import jax.numpy as jnp

    t = keep.shape[0]
    # Trace-time guard: the ring must hold one full t-row block past the
    # logical capacity, or dynamic_update_slice would clamp the start
    # backward near the end and silently corrupt previously-emitted rows
    # (the constructor sizes the slack from the decoder row count; this
    # assert turns any future drift into a loud error).
    assert state.emit_buf.shape[0] >= ecap + t, (
        state.emit_buf.shape, ecap, t)
    key = jnp.where(keep, jnp.arange(t, dtype=jnp.int32),
                    jnp.int32(1 << 30))
    _, s_ue, s_bs, s_rss, s_clk = jax.lax.sort(
        (key, combined[:, 1], corrected, combined[:, 3], combined[:, 4]),
        num_keys=1)
    block = jnp.stack([s_ue, s_bs, s_rss, s_clk], axis=1)
    total_kept = jnp.sum(keep.astype(jnp.int32))
    ring_overflow = state.emit_count + total_kept > ecap
    new_buf = jax.lax.dynamic_update_slice(
        state.emit_buf, block, (state.emit_count, jnp.int32(0)))
    new_count = jnp.minimum(state.emit_count + total_kept, ecap)
    return new_buf, new_count, ring_overflow


def _paths_substep(
    p: PathsState,
    combined,                  # jnp [t, 5] i32 (flag, ue, bs, rss, clk)
    corrected,                 # jnp [t] i32 corrected BS per row
    keep,                      # jnp [t] bool — kept (filtered) closed rows
    spec: StreamPathsSpec,
    dict_args,                 # (phi_rx, phi_tx, aoa_grid, aod_grid) jnp f32
    close_all: bool,
    tracker_kernel: bool = False,
):
    """Advance the online-estimation state by one step's kept rows.

    Kept rows are exactly the offline filtered table's rows in stream
    order (the emit-ring parity theorem), so segmenting THEM by UE
    decrease — seeded with ``last_kept_ue`` across steps — reproduces
    ``detect_groups_np(filtered[:, 0])`` exactly.  A kept-sweep may span
    chunk boundaries (its closing UE decrease can only be observed
    later), so the open sweep's cells accumulate in ``open_sums/counts``
    until a later step (or the flush, ``close_all=True``) closes it; the
    sweeps that DO close this step are fully determined, run through the
    per-sweep estimator (same program body as Session.sweep_paths) and
    the tracker scan (same step fn as track_paths_jax) inside this jit.

    Steps that close nothing take a cheap branch: one session-level
    accumulation into the open sweep, no estimator.
    """
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.models.sweep_estimation import sweep_estimator_body
    from slam_process_tpu.models.tracking import make_track_sweep_step
    from slam_process_tpu.ops.scene import intensity_per_sweep_sums_jax

    ue = combined[:, 1]
    clk = combined[:, 4]
    rss_i = combined[:, 3]
    t = ue.shape[0]
    rows = jnp.arange(t, dtype=jnp.int32)
    s1 = spec.s_step + 1
    palloc = p.time_ring.shape[0]

    # Kept-row sweep boundaries (carry-seeded last-valid scan).
    def _kl(a, b):
        au, av = a
        bu, bv = b
        return jnp.where(bv, bu, au), av | bv

    s_ue, s_v = jax.lax.associative_scan(_kl, (ue, keep))
    prev_ue = jnp.concatenate([s_ue[:1] * 0, s_ue[:-1]])
    prev_v = jnp.concatenate([jnp.zeros((1,), bool), s_v[:-1]])
    prev_eff = jnp.where(prev_v, prev_ue, p.last_kept_ue)
    has_prev = prev_v | (p.last_kept_ue >= 0)
    bnd = keep & has_prev & (prev_eff > ue)
    ls = jnp.cumsum(bnd.astype(jnp.int32))          # local sweep id per row
    m = jnp.sum(bnd.astype(jnp.int32))              # sweeps closed by boundary
    last_ue_new = jnp.where(s_v[-1], s_ue[-1], p.last_kept_ue)

    def full_branch(p):
        use = keep & (ls < s1)
        with jax.named_scope("sweep_sums"):
            sums, counts = intensity_per_sweep_sums_jax(
                ue, corrected, rss_i, ls, use, max_sweeps=s1,
                cfg=SceneConfig())
        sums = sums.at[0].add(p.open_sums)
        counts = counts.at[0].add(p.open_counts)

        # First kept row's CLK per local sweep; sweep 0 inherits the open
        # sweep's anchor when one exists.  (The [s1, t] membership plane
        # + row-min is one fused reduction.)
        in_s = use[None, :] & (ls[None, :] == jnp.arange(s1)[:, None])
        first = jnp.min(jnp.where(in_s, rows[None, :], t), axis=1)
        clk_pad = jnp.concatenate([clk, -jnp.ones((1,), jnp.int32)])
        times = clk_pad[jnp.minimum(first, t)]
        times = times.at[0].set(
            jnp.where(p.open_time >= 0, p.open_time, times[0]))

        # Sweeps that close: the m boundary-closed ones, plus (at flush)
        # the final open sweep when it has any cells.
        mc = jnp.minimum(m, s1 - 1)
        if close_all:
            has_open = jnp.sum(
                jax.lax.dynamic_index_in_dim(counts, mc, 0, False)) > 0
            m_eff = m + has_open.astype(jnp.int32)
        else:
            m_eff = m

        # Estimator in 8-lane blocks under a while_loop: closed sweeps
        # sit contiguously at lanes [0, m_eff), so running ceil(m_eff/8)
        # blocks skips the (s1 - m_eff) wasted lanes a whole-[s1] batch
        # would pay for.  The last block clamps its start
        # so overlapped lanes recompute identically (vmap lanes are
        # independent — the offline path already proves lane results are
        # batch-size invariant via its bucketed shapes); every ring row
        # is written at its true offset either way, and rows beyond the
        # final n_closed are never read.
        mean = jnp.where(counts > 0, sums / jnp.maximum(counts, 1.0),
                         jnp.nan)
        sub = jnp.take(mean, jnp.asarray(spec.ue_ids), axis=1,
                       mode="fill", fill_value=jnp.nan)
        sub = jnp.take(sub, jnp.asarray(spec.bs_ids), axis=2,
                       mode="fill", fill_value=jnp.nan)
        run_all = sweep_estimator_body(spec.est_key)
        blk = min(8, s1)
        m_eff_c = jnp.minimum(m_eff, s1)
        off = p.n_closed
        k_n = p.est_rings.valid.shape[1]
        zeros_l = (jnp.zeros((s1, k_n), jnp.float32),
                   jnp.zeros((s1, k_n), jnp.float32),
                   jnp.zeros((s1, k_n), jnp.float32),
                   jnp.zeros((s1, k_n), bool))

        def est_body(st):
            i, ests, vring, aoa_l, aod_l, pow_l, val_l = st
            start = jnp.minimum(i, s1 - blk)
            sub_blk = jax.lax.dynamic_slice_in_dim(sub, start, blk, 0)
            with jax.default_matmul_precision("highest"):
                eb, sv = run_all(sub_blk.astype(jnp.float32), *dict_args)
            j = off + start

            def wr(ring, b):
                idx = (j,) + (jnp.int32(0),) * (b.ndim - 1)
                return jax.lax.dynamic_update_slice(ring, b, idx)

            ests = jax.tree.map(wr, ests, eb)
            vring = jax.lax.dynamic_update_slice(vring, sv, (j,))
            pw = eb.power if hasattr(eb, "power") else eb.metric
            vb = jnp.asarray(eb.valid, bool) & sv[:, None]
            upd = jax.lax.dynamic_update_slice_in_dim
            aoa_l = upd(aoa_l, jnp.asarray(eb.aoa, jnp.float32), start, 0)
            aod_l = upd(aod_l, jnp.asarray(eb.aod, jnp.float32), start, 0)
            pow_l = upd(pow_l, jnp.asarray(pw, jnp.float32), start, 0)
            val_l = upd(val_l, vb, start, 0)
            return i + blk, ests, vring, aoa_l, aod_l, pow_l, val_l

        with jax.named_scope("sweep_estimator"):
            (_, est_rings, valid_ring, aoa_l, aod_l, pow_l,
             val_l) = jax.lax.while_loop(
                lambda st: st[0] < m_eff_c, est_body,
                (jnp.int32(0), p.est_rings, p.valid_ring) + zeros_l)

        # Ring block writer (the time_ring pattern): one s1-row
        # dynamic_update_slice at offset n_closed; one block of slack is
        # allocated, and junk lanes beyond m_eff are overwritten by
        # later blocks / never read past the final n_closed.
        def write(ring, block):
            idx = (off,) + (jnp.int32(0),) * (block.ndim - 1)
            return jax.lax.dynamic_update_slice(ring, block, idx)

        # Tracker: advance the carry over exactly the closed sweeps —
        # identical step ops in identical order to the offline scan.
        # Lanes >= m_eff are never fed to it.  On the GPU one Triton
        # kernel launch runs the whole block with the carry in registers
        # (ops/pallas_tracker.py); elsewhere the while_loop below.
        if tracker_kernel:
            from slam_process_tpu.ops.pallas_tracker import (
                track_block_pallas,
            )

            with jax.named_scope("tracker"):
                (blk_a, blk_d, blk_p, blk_o, pos, created,
                 count) = track_block_pallas(
                    aoa_l, aod_l, pow_l, val_l.astype(jnp.int32), m_eff_c,
                    p.trk_pos, p.trk_created, p.trk_count,
                    gate_deg=spec.gate_deg)
            trk_aoa = write(p.trk_aoa, blk_a)
            trk_aod = write(p.trk_aod, blk_d)
            trk_pow = write(p.trk_pow, blk_p)
            trk_obs = write(p.trk_obs, blk_o)
        else:
            closed_lane = jnp.arange(s1) < m_eff
            trk_valid = val_l & closed_lane[:, None]
            step_fn = make_track_sweep_step(
                k_n, spec.max_tracks, spec.gate_deg)
            xs = (aoa_l, aod_l, pow_l, trk_valid)

            def trk_body(st):
                i, pos, created, count, r_aoa, r_aod, r_pow, r_obs = st
                inp = tuple(
                    jax.lax.dynamic_index_in_dim(x, i, 0, False)
                    for x in xs)
                (pos, created, count), (ya, yd, yp, yo) = step_fn(
                    (pos, created, count), inp)
                j = jnp.minimum(off + i, r_aoa.shape[0] - 1)
                r_aoa = jax.lax.dynamic_update_index_in_dim(
                    r_aoa, ya, j, 0)
                r_aod = jax.lax.dynamic_update_index_in_dim(
                    r_aod, yd, j, 0)
                r_pow = jax.lax.dynamic_update_index_in_dim(
                    r_pow, yp, j, 0)
                r_obs = jax.lax.dynamic_update_index_in_dim(
                    r_obs, yo, j, 0)
                return (i + 1, pos, created, count, r_aoa, r_aod, r_pow,
                        r_obs)

            with jax.named_scope("tracker"):
                (_, pos, created, count, trk_aoa, trk_aod, trk_pow,
                 trk_obs) = jax.lax.while_loop(
                    lambda st: st[0] < m_eff_c, trk_body,
                    (jnp.int32(0), p.trk_pos, p.trk_created, p.trk_count,
                     p.trk_aoa, p.trk_aod, p.trk_pow, p.trk_obs))

        overflow = (p.overflow | (m_eff > spec.s_step)
                    | (p.n_closed + m_eff > spec.capacity))

        # New open accumulator = local sweep m's partial (when m == 0 the
        # open contribution is already folded into plane 0).  At flush
        # everything is closed: reset.
        if close_all:
            open_sums = jnp.zeros_like(p.open_sums)
            open_counts = jnp.zeros_like(p.open_counts)
            open_time = jnp.int32(-1)
        else:
            open_sums = jax.lax.dynamic_index_in_dim(sums, mc, 0, False)
            open_counts = jax.lax.dynamic_index_in_dim(counts, mc, 0, False)
            open_time = jnp.where(jnp.sum(open_counts) > 0, times[mc],
                                  jnp.int32(-1))
        return p._replace(
            open_sums=open_sums, open_counts=open_counts,
            open_time=open_time, last_kept_ue=last_ue_new,
            n_closed=jnp.minimum(p.n_closed + m_eff,
                                 jnp.int32(spec.capacity)),
            overflow=overflow,
            est_rings=est_rings,
            valid_ring=valid_ring,
            time_ring=write(p.time_ring, times),
            trk_pos=pos, trk_created=created, trk_count=count,
            trk_aoa=trk_aoa, trk_aod=trk_aod,
            trk_pow=trk_pow, trk_obs=trk_obs,
        )

    assert palloc >= spec.capacity + s1, (palloc, spec.capacity, s1)
    # No cheap/full conditional: with the estimator and tracker loops
    # bounded by m_eff, a step that closes nothing costs one per-sweep
    # sums pass and zero loop iterations, and its state update is
    # provably identical to the former fold-into-open-sweep branch
    # (sums[0] accumulates the open sweep either way; both formulations
    # are exact integer sums), and a lax.cond wrapper would copy the
    # paths state on every step.
    return full_branch(p)


def _step_body(
    state: DeviceStreamState,
    chunk,                     # jnp [C] u8 (zero-padded past n_bytes)
    n_bytes,                   # jnp scalar i32
    dict_args=(),              # jnp f32 dictionary tensors when paths_spec
    *,
    cap: int,
    group_capacity: int,
    max_groups: int,
    max_baselines_per_group: int,
    cfg: PipelineConfig,
    emit_capacity: int,
    paths_spec: Optional[StreamPathsSpec] = None,
    tracker_kernel: bool = False,
):
    import jax
    import jax.numpy as jnp

    # Gather-free masked-row decode (ops/decode.decode_rows_jax); mask to
    # frames fully inside chunk[:n_bytes] so correctness on short/padded
    # pieces is explicit, not a property of the pad bytes.
    new_rows, new_valid, n_new = decode_rows_jax(chunk, cfg=cfg.decode,
                                                 n_valid=n_bytes)

    cc = state.carry_count
    gcap = group_capacity
    t = gcap + new_rows.shape[0]

    # Masked-row combine: dense carry prefix + the chunk's masked rows.
    # Static concatenation — no per-row gather.
    rows = jnp.arange(t, dtype=jnp.int32)
    combined = jnp.concatenate([state.carry_frames, new_rows])
    valid = jnp.concatenate(
        [jnp.arange(gcap, dtype=jnp.int32) < cc, new_valid]
    )

    # Sweep boundaries: a UE decrease vs the previous VALID row starts a
    # new group; the first valid row continues the carried-over open group
    # (has_prev is False there exactly when the carry is empty, i.e. start
    # of stream, where the reference also opens the first group).
    ue = combined[:, 1]

    def _kl(a, b):
        au, av = a
        bu, bv = b
        return jnp.where(bv, bu, au), av | bv

    s_ue, s_v = jax.lax.associative_scan(_kl, (ue, valid))
    prev_ue = jnp.concatenate([s_ue[:1] * 0, s_ue[:-1]])
    has_prev = jnp.concatenate([jnp.zeros((1,), bool), s_v[:-1]])
    boundary = valid & has_prev & (prev_ue > ue)
    closed = jnp.max(jnp.where(boundary, rows, 0))   # 0 when no boundary

    from slam_process_tpu.ops.correct import correct_rows_jax

    corrected, keep, c_overflow = correct_rows_jax(
        combined, valid & (rows < closed), max_groups=max_groups,
        max_baselines_per_group=max_baselines_per_group, cfg=cfg.correct,
    )

    d_sums, d_counts = intensity_sums_jax(
        combined[:, 1], corrected, combined[:, 3].astype(jnp.float32), keep,
        combined[:, 0], cfg.scene,
    )

    # New carry: the open group's valid rows in [closed, t), compacted into
    # the dense [gcap] buffer.
    open_mask = valid & (rows >= closed)
    n_carry = jnp.sum(open_mask.astype(jnp.int32))
    src = jnp.nonzero(open_mask, size=gcap, fill_value=t)[0]
    combined_pad = jnp.concatenate([combined, jnp.zeros((1, 5), jnp.int32)])
    new_carry = combined_pad[src]

    if emit_capacity:
        emit_buf, emit_count, ring_overflow = _emit_kept_rows(
            state, combined, corrected, keep, emit_capacity)
    else:
        emit_buf, emit_count, ring_overflow = (
            state.emit_buf, state.emit_count, False)

    if paths_spec is not None:
        new_paths = _paths_substep(state.paths, combined, corrected, keep,
                                   paths_spec, dict_args, close_all=False,
                                   tracker_kernel=tracker_kernel)
    else:
        new_paths = state.paths

    return DeviceStreamState(
        carry_frames=new_carry.astype(jnp.int32),
        carry_count=jnp.minimum(n_carry, gcap),
        sums=state.sums + d_sums,
        counts=state.counts + d_counts,
        n_frames=state.n_frames + n_new,
        n_kept=state.n_kept + jnp.sum(keep.astype(jnp.int32)),
        n_groups=state.n_groups + jnp.sum(boundary.astype(jnp.int32)),
        overflow=state.overflow | c_overflow | (n_carry > gcap),
        emit_buf=emit_buf,
        emit_count=emit_count,
        emit_overflow=state.emit_overflow | ring_overflow,
        paths=new_paths,
    )


def _flush_body(
    state: DeviceStreamState,
    dict_args=(),
    *,
    max_groups: int,
    max_baselines_per_group: int,
    cfg: PipelineConfig,
    emit_capacity: int,
    paths_spec: Optional[StreamPathsSpec] = None,
    tracker_kernel: bool = False,
):
    """Close the final open group at end of stream."""
    import jax.numpy as jnp

    from slam_process_tpu.ops.correct import correct_frames_jax

    corrected, keep, c_overflow = correct_frames_jax(
        state.carry_frames, state.carry_count, max_groups=max_groups,
        max_baselines_per_group=max_baselines_per_group, cfg=cfg.correct,
    )
    d_sums, d_counts = intensity_sums_jax(
        state.carry_frames[:, 1], corrected,
        state.carry_frames[:, 3].astype(jnp.float32), keep,
        state.carry_frames[:, 0], cfg.scene,
    )
    if emit_capacity:
        emit_buf, emit_count, ring_overflow = _emit_kept_rows(
            state, state.carry_frames, corrected, keep, emit_capacity)
    else:
        emit_buf, emit_count, ring_overflow = (
            state.emit_buf, state.emit_count, False)
    if paths_spec is not None:
        new_paths = _paths_substep(state.paths, state.carry_frames, corrected,
                                   keep, paths_spec, dict_args,
                                   close_all=True,
                                   tracker_kernel=tracker_kernel)
    else:
        new_paths = state.paths
    return DeviceStreamState(
        carry_frames=jnp.zeros_like(state.carry_frames),
        carry_count=jnp.zeros_like(state.carry_count),
        sums=state.sums + d_sums,
        counts=state.counts + d_counts,
        n_frames=state.n_frames,
        n_kept=state.n_kept + jnp.sum(keep.astype(jnp.int32)),
        n_groups=state.n_groups + (state.carry_count > 0).astype(jnp.int32),
        overflow=state.overflow | c_overflow,
        emit_buf=emit_buf,
        emit_count=emit_count,
        emit_overflow=state.emit_overflow | ring_overflow,
        paths=new_paths,
    )


@functools.lru_cache(maxsize=16)
def _build_step(cap, gcap, max_groups, max_bpg, cfg, emit_capacity,
                paths_spec=None):
    """Shared jitted step per static configuration (the config dataclasses
    are frozen/hashable), so many sessions reuse one compiled executable."""
    import jax

    from slam_process_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    return jax.jit(
        functools.partial(
            _step_body, cap=cap, group_capacity=gcap, max_groups=max_groups,
            max_baselines_per_group=max_bpg, cfg=cfg,
            emit_capacity=emit_capacity, paths_spec=paths_spec,
            tracker_kernel=_use_tracker_kernel(),
        ),
        donate_argnums=0,
    )


def _use_tracker_kernel() -> bool:
    """The Triton tracker kernel runs where it compiles: the GPU backend."""
    import jax

    return jax.default_backend() == "gpu"


def _multi_tracker_kernel(mesh) -> bool:
    """The kernel in the vmapped multi-stream step: only when the stream
    axis lives on one device.  The kernel is a custom call that XLA's
    partitioner has no rule to split across a sharded stream axis, so
    sharded sessions keep the while_loop (identical results)."""
    return _use_tracker_kernel() and (mesh is None or mesh.devices.size == 1)


def _paths_state_zero(spec: StreamPathsSpec, ga: int, gd: int):
    """The zero PathsState (traced): ring shapes come from the estimator's
    output structure via eval_shape — no estimator code runs here."""
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.models.sweep_estimation import sweep_estimator_body

    s1 = spec.s_step + 1
    u, b = len(spec.ue_ids), len(spec.bs_ids)
    palloc = spec.capacity + s1
    tks = spec.max_tracks

    run_all = sweep_estimator_body(spec.est_key)
    est_shape, _valid_shape = jax.eval_shape(
        run_all,
        jax.ShapeDtypeStruct((s1, u, b), jnp.float32),
        jax.ShapeDtypeStruct((u, ga), jnp.float32),
        jax.ShapeDtypeStruct((b, gd), jnp.float32),
        jax.ShapeDtypeStruct((ga,), jnp.float32),
        jax.ShapeDtypeStruct((gd,), jnp.float32),
    )
    est_rings = jax.tree.map(
        lambda s: jnp.zeros((palloc,) + s.shape[1:], s.dtype), est_shape)
    return PathsState(
        open_sums=jnp.zeros((64, 64), jnp.float32),
        open_counts=jnp.zeros((64, 64), jnp.float32),
        open_time=jnp.int32(-1),
        last_kept_ue=jnp.int32(-1),
        n_closed=jnp.int32(0),
        overflow=jnp.bool_(False),
        est_rings=est_rings,
        valid_ring=jnp.zeros((palloc,), bool),
        time_ring=jnp.zeros((palloc,), jnp.int32),
        trk_pos=jnp.zeros((tks, 2), jnp.float32),
        trk_created=jnp.zeros((tks,), bool),
        trk_count=jnp.int32(0),
        trk_aoa=jnp.zeros((palloc, tks), jnp.float32),
        trk_aod=jnp.zeros((palloc, tks), jnp.float32),
        trk_pow=jnp.zeros((palloc, tks), jnp.float32),
        trk_obs=jnp.zeros((palloc, tks), bool),
    )


@functools.lru_cache(maxsize=16)
def _build_init(gcap: int, n_beams: int, emit_capacity: int,
                paths_spec=None, ga: int = 0, gd: int = 0):
    """One jitted call producing the zero state (vs separate allocs)."""
    import jax
    import jax.numpy as jnp

    def init():
        return DeviceStreamState(
            carry_frames=jnp.zeros((gcap, 5), jnp.int32),
            carry_count=jnp.int32(0),
            sums=jnp.zeros((n_beams, n_beams), jnp.float32),
            counts=jnp.zeros((n_beams, n_beams), jnp.float32),
            n_frames=jnp.int32(0),
            n_kept=jnp.int32(0),
            n_groups=jnp.int32(0),
            overflow=jnp.bool_(False),
            emit_buf=jnp.zeros((emit_capacity, 4), jnp.int32),
            emit_count=jnp.int32(0),
            emit_overflow=jnp.bool_(False),
            paths=(_paths_state_zero(paths_spec, ga, gd)
                   if paths_spec is not None else None),
        )

    from slam_process_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    return jax.jit(init)


@functools.lru_cache(maxsize=16)
def _build_emit_grow(old_alloc: int, new_alloc: int):
    """Device-side emit-ring doubling: copy the old ring into a larger
    zero buffer (one dynamic_update_slice; no host read anywhere)."""
    import jax
    import jax.numpy as jnp

    def grow(state: DeviceStreamState) -> DeviceStreamState:
        new_buf = jnp.zeros((new_alloc, 4), jnp.int32)
        new_buf = jax.lax.dynamic_update_slice(new_buf, state.emit_buf,
                                               (jnp.int32(0), jnp.int32(0)))
        return state._replace(emit_buf=new_buf)

    return jax.jit(grow, donate_argnums=0)


@functools.lru_cache(maxsize=16)
def _build_flush(max_groups, max_bpg, cfg, emit_capacity, paths_spec=None):
    import jax

    return jax.jit(
        functools.partial(
            _flush_body, max_groups=max_groups,
            max_baselines_per_group=max_bpg, cfg=cfg,
            emit_capacity=emit_capacity, paths_spec=paths_spec,
            tracker_kernel=_use_tracker_kernel(),
        ),
        donate_argnums=0,
    )


class DeviceStreamingSession:
    """Unbounded-stream session with all state resident on device.

    ``feed`` enqueues one jitted step per ``chunk_bytes`` window with the
    state buffers donated (no reallocation, no host sync); scalars/grids
    transfer only when a result property is read.
    """

    def __init__(
        self,
        config: Optional[PipelineConfig] = None,
        chunk_bytes: int = 1 << 20,
        # The carry holds the OPEN sweep group across a window boundary, so
        # it must exceed the largest single UE group in the stream.  The
        # reference dataset's max group is 4,361 frames — the old 4096
        # default silently dropped 128
        # kept rows from that log whenever its big group straddled a 1 MiB
        # window edge (chunk-phase dependent, so most replays passed).
        # 8192 gives ~1.9x headroom; overflow still warns loudly.
        #
        # The other two bounds get the same ~2x-over-observed treatment
        # (dataset maxima at 1 MiB windows: 56 closed groups/window, 93
        # baselines/group — the old 64/96 defaults had 14%/3% headroom
        # against the same silent-truncation failure).  Cost: the
        # corrector's one-hot planes scale linearly in both, ~20% on the
        # streaming step; pass tighter bounds to trade safety for speed.
        group_capacity: int = 8192,
        max_groups: int = 128,
        max_baselines_per_group: int = 192,
        collect_filtered: bool = False,
        n_beams: int = 64,
        emit_capacity: Optional[int] = None,
        collect_paths=None,   # (spec, dict_args) from make_paths_spec
    ):
        self.config = config or PipelineConfig()
        self.chunk_bytes = int(chunk_bytes)
        if self.chunk_bytes <= CARRY_BYTES:
            raise ValueError("chunk_bytes must exceed the 10-byte carry")
        self.collect_filtered = bool(collect_filtered)
        self._gcap = int(group_capacity)
        # Emit ring: kept rows accumulate on device and drain ONCE when
        # `filtered` is read (no device-to-host read in the feed loop).
        #
        # Capacity policy: an explicit ``emit_capacity`` is FIXED (overflow
        # flags and result reads raise — never truncate).  The default
        # (None) AUTO-GROWS: the host tracks a conservative upper bound on
        # emitted rows (kept <= decoded <= one frame per 11 bytes fed — no
        # device read needed), and before a window that could exceed the
        # ring, a device-side copy program doubles it.  Growth recompiles
        # the step for the new static shape, so unbounded streams pay a
        # (rare, amortized-2x) compile per doubling; size up front via
        # ``emit_capacity`` (replay_log_device auto-sizes from the log)
        # to avoid even that.
        self._emit_auto = self.collect_filtered and emit_capacity is None
        if self.collect_filtered:
            ecap = int(emit_capacity) if emit_capacity is not None else 1 << 18
        else:
            ecap = 0
        self._emit_bound = 0
        self._ecap = ecap
        cap = frame_capacity(self.chunk_bytes, self.config.decode)

        # Online estimation + tracking (the offline flagship, in-stream).
        if collect_paths is not None:
            import jax.numpy as jnp

            spec, dict_args = collect_paths
            self._paths_spec: Optional[StreamPathsSpec] = spec
            self._dict_args = tuple(jnp.asarray(a, jnp.float32)
                                    for a in dict_args)
            ga, gd = len(dict_args[2]), len(dict_args[3])
        else:
            self._paths_spec = None
            self._dict_args = ()
            ga = gd = 0

        self._cap = cap
        self._mg = max_groups
        self._mbpg = max_baselines_per_group
        self._n_beams = int(n_beams)
        # Ring allocation = logical capacity + one block of slack
        # (gcap + chunk rows): the emit block write is a fixed t-row
        # dynamic_update_slice whose tail may exceed the logical capacity
        # with junk that later blocks overwrite (see _emit_kept_rows).
        self._emit_slack = self._gcap + (-(-self.chunk_bytes // 11))

        # Donated state: accumulators update in place on device; the
        # compiled step is shared across sessions with the same config.
        self._build_programs()
        self._state = _build_init(self._gcap, n_beams, self._emit_alloc(),
                                  self._paths_spec, ga, gd)()
        self._byte_carry = np.zeros(0, dtype=np.uint8)
        self._finalized = False
        self._overflow_warned = False

    def _emit_alloc(self) -> int:
        return self._ecap + self._emit_slack if self._ecap else 0

    def _build_programs(self) -> None:
        self._step = _build_step(
            self._cap, self._gcap, self._mg, self._mbpg,
            self.config, self._ecap, self._paths_spec,
        )
        self._flush = _build_flush(
            self._mg, self._mbpg, self.config, self._ecap, self._paths_spec,
        )

    def _maybe_grow_emit(self, rows_next: int) -> None:
        """Auto-grow the emit ring BEFORE a window that could overflow it.

        ``self._emit_bound`` over-counts kept rows (one frame per 11 fed
        bytes, every kept row decoded exactly once), so growing whenever
        the bound plus the next window's worst case crosses the logical
        capacity guarantees the ring never overflows — with zero device
        reads in the feed loop.
        """
        if not self._emit_auto:
            return
        need = self._emit_bound + rows_next
        if need <= self._ecap:
            return
        new_ecap = max(self._ecap * 2, need)
        new_ecap = -(-new_ecap // (1 << 18)) * (1 << 18)
        old_alloc = self._emit_alloc()
        self._ecap = new_ecap
        _LOGGER.info("emit ring auto-grow: %d -> %d rows", old_alloc,
                     self._emit_alloc())
        self._state = _build_emit_grow(old_alloc, self._emit_alloc())(
            self._state)
        self._build_programs()

    # -- ingest --------------------------------------------------------------

    def feed(self, chunk: Union[bytes, np.ndarray]) -> None:
        """Consume one chunk of tokenized bytes (any length)."""
        import jax.numpy as jnp

        if self._finalized:
            raise RuntimeError(
                "session already finalized: the flush closed the open "
                "sweep group, so feeding more bytes would mis-segment "
                "sweeps; start (or restore) a non-finalized session")
        if isinstance(chunk, (bytes, bytearray)):
            chunk = np.frombuffer(chunk, dtype=np.uint8)
        buf = np.concatenate(
            [self._byte_carry, np.asarray(chunk, dtype=np.uint8)]
        )
        n = len(buf)
        c = self.chunk_bytes
        off = 0
        # Consecutive windows overlap by 10 bytes: a frame straddling a
        # window edge is decoded exactly once in the window that holds its
        # full 11-byte span (see module docstring for why this is lossless).
        while n - off > CARRY_BYTES:
            piece = buf[off : off + c]
            m = len(piece)
            if m < c:
                piece = np.pad(piece, (0, c - m))
            rows_next = m // 11 + 1
            self._maybe_grow_emit(rows_next)
            self._state = self._step(self._state, jnp.asarray(piece),
                                     jnp.int32(m), self._dict_args)
            self._emit_bound += rows_next
            off = min(off + c, n) - CARRY_BYTES
        self._byte_carry = buf[off:].copy()

    def finalize(self) -> None:
        """Flush the final open sweep group (end of stream).

        Performs no device read: overflow is checked lazily when a result
        is consumed (``_check_overflow``), so finalize never waits on the
        device.
        """
        if self._finalized:
            return
        self._state = self._flush(self._state, self._dict_args)
        self._byte_carry = np.zeros(0, dtype=np.uint8)
        self._finalized = True

    # -- results -------------------------------------------------------------

    def _check_overflow(self) -> None:
        """Warn loudly (once) when any static bound was exceeded.

        Called from every result consumer: an overflowed run has silently
        dropped or mis-corrected rows, so counts/grids are lower bounds.
        Unlike the batched Session path there is no host fallback here —
        the bytes are gone — so the fix is to rebuild the session with
        larger group_capacity / max_groups / max_baselines_per_group.
        """
        if self._overflow_warned or not bool(self._state.overflow):
            return
        self._overflow_warned = True
        import warnings

        msg = ("DeviceStreamingSession capacity exceeded (group_capacity/"
               "max_groups/max_baselines_per_group): results are incomplete;"
               " rebuild with larger bounds")
        warnings.warn(msg, RuntimeWarning, stacklevel=3)
        _LOGGER.warning(msg)

    @property
    def n_frames(self) -> int:
        self._check_overflow()
        return int(self._state.n_frames)

    @property
    def n_kept(self) -> int:
        self._check_overflow()
        return int(self._state.n_kept)

    @property
    def n_groups(self) -> int:
        self._check_overflow()
        return int(self._state.n_groups)

    @property
    def overflow(self) -> bool:
        return bool(self._state.overflow)

    @property
    def filtered(self) -> np.ndarray:
        """Corrected rows [N, 4] (ue, corrected_bs, rss, clk), stream order.

        Drains the device emit ring in one transfer.
        """
        import jax

        if not self.collect_filtered:
            raise ValueError("built with collect_filtered=False")
        self._check_overflow()
        if bool(self._state.emit_overflow):
            raise RuntimeError(
                f"emit ring overflowed: the stream kept {self.n_kept} rows "
                f"but emit_capacity is {self._ecap}; the "
                "exported table would be silently truncated — rebuild the "
                "session with a larger emit_capacity (counts/grids remain "
                "exact)")
        buf, count = jax.device_get((self._state.emit_buf,
                                     self._state.emit_count))
        return buf[: int(count)].astype(np.int64)

    # -- online estimation results -------------------------------------------

    def _paths_read(self):
        import jax

        if self._paths_spec is None:
            raise ValueError("built without collect_paths")
        self._check_overflow()
        p = self._state.paths
        host = jax.device_get((p.n_closed, p.overflow, p.est_rings,
                               p.valid_ring, p.time_ring, p.trk_aoa,
                               p.trk_aod, p.trk_pow, p.trk_obs,
                               p.trk_created, p.trk_count))
        (n, overflow, est, valid, times, taoa, taod, tpow, tobs,
         created, count) = host
        if bool(overflow):
            raise RuntimeError(
                f"online estimation overflow: more than "
                f"{self._paths_spec.s_step} sweeps closed in one step or "
                f"more than {self._paths_spec.capacity} sweeps total; "
                "rebuild the session with larger s_step/capacity "
                "(grids/counts remain exact)")
        return (int(n), est, valid, times, taoa, taod, tpow, tobs,
                created, int(count))

    def sweep_paths(self):
        """Online per-sweep estimates: (paths [n_closed, K], sweep_valid).

        Equals ``Session.sweep_paths(..., beam_ids=(spec.ue_ids,
        spec.bs_ids))`` on the same stream (exact-parity tested) — but
        produced incrementally as the stream's sweeps closed.
        """
        n, est, valid, *_ = self._paths_read()
        paths = type(est)(*(np.asarray(x)[:n] for x in est))
        return paths, np.asarray(valid)[:n]

    def sweep_times(self):
        """CLK anchors of the closed sweeps, unwrapped like the offline
        ``Session.sweep_times`` (shared helper)."""
        from slam_process_tpu.utils.timestamps import unwrap_clk_anchors

        n, _est, _valid, times, *_ = self._paths_read()
        return unwrap_clk_anchors(times[:n].astype(np.int64), _LOGGER)

    def path_tracks(self):
        """Online CLK-anchored tracks: (tracks, times, (vel_aoa, vel_aod,
        ok)) — the offline ``Session.path_tracks`` contract, produced by
        the in-stream tracker carry."""
        from slam_process_tpu.models.tracking import Tracks, track_velocities

        (n, _est, _valid, times, taoa, taod, tpow, tobs, created,
         count) = self._paths_read()
        tracks = Tracks(taoa[:n].T.copy(), taod[:n].T.copy(),
                        tpow[:n].T.copy(), tobs[:n].T.copy(),
                        created, count)
        t = self.sweep_times()
        vel = track_velocities(tracks, t)
        return tracks, t, vel

    def track_columns(self, lo: int, hi: int):
        """Track-ring columns for closed sweeps ``[lo, hi)``:
        ``(aoa [m, T], aod, power, observed, raw CLK anchors [m])``.

        The incremental read behind the live ``watch --events`` feed:
        transfers O(hi - lo) ring rows, not the whole state — the
        in-stream tracker carry already computed the columns, so a poll
        over an unbounded watch stays O(new sweeps).
        """
        import jax

        if self._paths_spec is None:
            raise ValueError("built without collect_paths")
        p = self._state.paths
        ov, a, d, pw, ob, tm = jax.device_get(
            (p.overflow, p.trk_aoa[lo:hi], p.trk_aod[lo:hi],
             p.trk_pow[lo:hi], p.trk_obs[lo:hi], p.time_ring[lo:hi]))
        if bool(ov):
            raise RuntimeError(
                f"online estimation overflow: more than "
                f"{self._paths_spec.s_step} sweeps closed in one step or "
                f"more than {self._paths_spec.capacity} sweeps total; "
                "rebuild the session with larger s_step/capacity "
                "(grids/counts remain exact)")
        return (np.asarray(a, np.float32), np.asarray(d, np.float32),
                np.asarray(pw, np.float32), np.asarray(ob, bool),
                np.asarray(tm, np.int64))

    @property
    def n_sweeps_closed(self) -> int:
        import jax

        if self._paths_spec is None:
            raise ValueError("built without collect_paths")
        return int(jax.device_get(self._state.paths.n_closed))

    def intensity(self) -> IntensityGrid:
        import jax

        from slam_process_tpu.ops.scene import grid_from_sums_np

        self._check_overflow()

        sums, counts = jax.device_get((self._state.sums, self._state.counts))
        return grid_from_sums_np(sums.astype(np.float64),
                                 counts.astype(np.int64))

    def render(self, angle_lut: np.ndarray, render_cfg=None):
        from slam_process_tpu.config import RenderConfig, SceneConfig
        from slam_process_tpu.render.heatmap import render_intensity

        return render_intensity(
            self.intensity(), angle_lut,
            SceneConfig(keep_nan=True, fill_with_min=False),
            render_cfg or RenderConfig(),
        )

    def block_until_ready(self):
        import jax

        jax.block_until_ready(self._state.sums)
        return self

    # -- checkpoint / resume ---------------------------------------------

    def save_checkpoint(self, path, extra: Optional[dict] = None) -> None:
        """Write the full streaming state to ``path`` (one npz file).

        Captures everything: the device state machine (carry frames, open
        sweep group, intensity accumulators, emit ring, online-estimation
        rings and tracker carry), the host byte carry, and the session
        configuration.  ``DeviceStreamingSession.restore(path)`` continues
        the stream exactly — mid-stream crash recovery for unbounded live
        captures (SURVEY §5.4; see the module-level checkpoint notes for
        the D2H/pickle caveats).  ``extra`` rides along for the caller
        (e.g. ``cli watch`` stores its file offset + tokenizer text carry)
        and comes back as ``restored.checkpoint_extra``.
        """
        meta = {
            "extra": extra,
            "version": _CKPT_VERSION,
            "kind": "device_stream",
            "config": self.config,
            "chunk_bytes": self.chunk_bytes,
            "group_capacity": self._gcap,
            "max_groups": self._mg,
            "max_baselines_per_group": self._mbpg,
            "collect_filtered": self.collect_filtered,
            "n_beams": self._n_beams,
            "emit_auto": self._emit_auto,
            "ecap": self._ecap,
            "emit_bound": self._emit_bound,
            "finalized": self._finalized,
            "paths_spec": self._paths_spec,
            "dict_args": tuple(np.asarray(a) for a in self._dict_args),
            "byte_carry": np.asarray(self._byte_carry, np.uint8),
        }
        _ckpt_write(path, self._state, meta)

    @classmethod
    def restore(cls, path) -> "DeviceStreamingSession":
        """Rebuild a session from :meth:`save_checkpoint` output.

        The restored session reuses (or recompiles, once per process) the
        same cached step programs, verifies the checkpoint's state leaves
        against the configuration's zero state, and continues the stream
        where it left off; results after feeding the remainder are
        EXACTLY equal to an uninterrupted run.
        """
        meta, leaves = _ckpt_read(path)
        if meta.get("kind") != "device_stream":
            raise ValueError(
                f"not a DeviceStreamingSession checkpoint: kind="
                f"{meta.get('kind')!r} (MultiStreamingSession checkpoints "
                "restore via MultiStreamingSession.restore)")
        spec = meta["paths_spec"]
        sess = cls(
            config=meta["config"],
            chunk_bytes=meta["chunk_bytes"],
            group_capacity=meta["group_capacity"],
            max_groups=meta["max_groups"],
            max_baselines_per_group=meta["max_baselines_per_group"],
            collect_filtered=meta["collect_filtered"],
            n_beams=meta["n_beams"],
            emit_capacity=(meta["ecap"] if meta["collect_filtered"]
                           else None),
            collect_paths=((spec, meta["dict_args"])
                           if spec is not None else None),
        )
        sess._emit_auto = bool(meta["emit_auto"])
        sess._emit_bound = int(meta["emit_bound"])
        sess._finalized = bool(meta["finalized"])
        sess._byte_carry = np.asarray(meta["byte_carry"], np.uint8)
        sess._state = _ckpt_swap_state(sess._state, leaves)
        sess.checkpoint_extra = meta.get("extra")
        return sess


# -- checkpoint / resume -----------------------------------------------------
#
# SURVEY.md §5.4: the reference's only "checkpointing" is its durable .xlsx
# stage artifacts (bs_beam_correction.py:136-138 even overwrites its input
# in-place).  The offline Session mirrors that with npz stage artifacts; the
# STREAMING axis additionally needs mid-stream state checkpoints — an
# unbounded live capture cannot be re-fed from the start after a crash, so
# the device-resident state machine itself must round-trip through disk.
#
# A checkpoint is one npz file: every leaf of the DeviceStreamState pytree
# (read back with a single device_get) plus a pickled meta blob holding the
# constructor configuration and the host-side carry/bookkeeping.  Restore
# rebuilds the session from the saved configuration (compiling or reusing
# the same cached step program), verifies every leaf's shape/dtype against
# the freshly built zero state, and places the saved leaves on device —
# feeding the remaining stream then produces results EXACTLY equal to an
# uninterrupted run (tests/test_streaming_device.py).
#
# Saving reads the full state back from the device, so a checkpoint waits
# for every queued step.  Older checkpoints also carry a "decoder" meta
# field; it is ignored.  Loading unpickles the meta blob; open checkpoints
# you wrote, not untrusted files.

_CKPT_VERSION = 1


def _ckpt_write(path, state, meta: dict) -> None:
    import os
    import pickle

    import jax

    leaves = jax.device_get(jax.tree.leaves(state))
    blob = np.frombuffer(pickle.dumps(meta, protocol=4), dtype=np.uint8)
    arrays = {f"leaf_{i:04d}": np.asarray(x) for i, x in enumerate(leaves)}
    # Atomic replace: a crash mid-save must not corrupt the last good
    # checkpoint (the whole point of having one).  Through a file handle:
    # np.savez(path) appends ".npz" to bare paths, which would make
    # save/restore disagree about the file name.
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, meta=blob, n_leaves=np.int64(len(leaves)), **arrays)
    os.replace(tmp, path)


def _ckpt_read(path):
    import pickle

    with np.load(path, allow_pickle=False) as z:
        meta = pickle.loads(z["meta"].tobytes())
        # Host-engine (StreamingSession) checkpoints share the meta/kind
        # layout but carry named arrays instead of a pytree leaf table;
        # let the caller's kind check produce the right error.
        n = int(z["n_leaves"]) if "n_leaves" in z else 0
        leaves = [z[f"leaf_{i:04d}"] for i in range(n)]
    if meta.get("version") != _CKPT_VERSION:
        raise ValueError(
            f"unsupported checkpoint version {meta.get('version')!r} "
            f"(this build reads version {_CKPT_VERSION})")
    return meta, leaves


def _ckpt_swap_state(zero_state, leaves, *, place=None):
    """Replace ``zero_state``'s leaves with the checkpointed ones.

    Shape/dtype of every leaf is verified against the zero state built
    from the restored configuration — any drift (changed estimator output
    structure, different capacities) fails loudly instead of producing a
    silently misaligned state.  ``place`` optionally maps each device
    array (e.g. mesh sharding for the multi-stream state).
    """
    import jax
    import jax.numpy as jnp

    zero_leaves, treedef = jax.tree.flatten(zero_state)
    if len(zero_leaves) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} state leaves, the restored "
            f"configuration builds {len(zero_leaves)}")
    new_leaves = []
    for i, (z, l) in enumerate(zip(zero_leaves, leaves)):
        if tuple(z.shape) != tuple(l.shape) or z.dtype != l.dtype:
            raise ValueError(
                f"checkpoint leaf {i} is {l.dtype}{list(l.shape)} but the "
                f"restored configuration expects {z.dtype}{list(z.shape)}")
        arr = jnp.asarray(l)
        new_leaves.append(place(arr) if place is not None else arr)
    return jax.tree.unflatten(treedef, new_leaves)


@functools.lru_cache(maxsize=8)
def _build_multi_step(cap, gcap, max_groups, max_bpg, cfg,
                      paths_spec=None, emit_capacity=0, tracker_kernel=False):
    """Vmapped streaming step: S independent streams advance in ONE
    program.  Sharding comes from the inputs (states/chunks laid out over
    the mesh 'data' axis) — XLA propagates it through the vmapped body, so
    S live streams on an S-device mesh each run on their own device with no
    collectives (the state machine is per-stream).  ``tracker_kernel``:
    see :func:`_multi_tracker_kernel`."""
    import jax

    from slam_process_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    body = functools.partial(
        _step_body, cap=cap, group_capacity=gcap, max_groups=max_groups,
        max_baselines_per_group=max_bpg, cfg=cfg,
        emit_capacity=emit_capacity, paths_spec=paths_spec,
        tracker_kernel=tracker_kernel,
    )
    return jax.jit(
        jax.vmap(lambda st, ch, nb, da: body(st, ch, nb, da),
                 in_axes=(0, 0, 0, None)),
        donate_argnums=0)


@functools.lru_cache(maxsize=8)
def _build_multi_flush(max_groups, max_bpg, cfg, paths_spec=None,
                       emit_capacity=0, tracker_kernel=False):
    """Masked vmapped flush: close the final open group of the streams
    selected by ``mask`` and keep every other stream's state untouched
    (live feeds end independently — see ``finalize_streams``).  The flush
    body runs for all S lanes (vmap has no ragged execution) and the
    per-leaf select keeps the donated-buffer update one program."""
    import jax
    import jax.numpy as jnp

    body = functools.partial(
        _flush_body, max_groups=max_groups, max_baselines_per_group=max_bpg,
        cfg=cfg, emit_capacity=emit_capacity, paths_spec=paths_spec,
        tracker_kernel=tracker_kernel,
    )

    def run(st, mask, da):
        new = jax.vmap(lambda s, d: body(s, d), in_axes=(0, None))(st, da)

        def sel(n, o):
            m = mask.reshape((-1,) + (1,) * (n.ndim - 1))
            return jnp.where(m, n, o)

        return jax.tree.map(sel, new, st)

    return jax.jit(run, donate_argnums=0)


@functools.lru_cache(maxsize=8)
def _build_multi_reset(gcap, n_beams, emit_alloc, paths_spec, ga, gd):
    """Masked per-stream reset: the selected lanes return to the zero
    state (NOT all-zeros — PathsState carries -1 sentinels, so the real
    init is broadcast in), everything else stays bit-identical.  Lets a
    finalized slot accept a NEW live feed without touching its siblings
    (``reset_streams``)."""
    import jax
    import jax.numpy as jnp

    init1 = _build_init(gcap, n_beams, emit_alloc, paths_spec, ga, gd)

    def run(st, mask):
        z = init1()

        def sel(o, zz):
            m = mask.reshape((-1,) + (1,) * (o.ndim - 1))
            return jnp.where(m, jnp.broadcast_to(zz, o.shape), o)

        return jax.tree.map(sel, st, z)

    return jax.jit(run, donate_argnums=0)


class MultiStreamingSession:
    """S live streams, one vmapped device program per step (mesh-shardable).

    The scaling shape for ingest: a deployment with many concurrent
    serial feeds runs them as ONE [S, ...] streaming state advanced by one
    program dispatch per chunk round, with the S axis sharded over a mesh
    'data' axis (each device owns its streams; no cross-device traffic).
    Per-stream results equal S independent :class:`DeviceStreamingSession`
    replays exactly (tests/test_multidevice.py).

    ``feed`` takes one chunk per stream (same chunk schedule across
    streams; pad the tail with empty chunks — a zero-length chunk is a
    provable no-op for the state machine).  Byte carries are handled per
    stream on the host exactly as in the single-stream session.
    """

    def __init__(
        self,
        n_streams: int,
        config: Optional[PipelineConfig] = None,
        chunk_bytes: int = 1 << 20,
        group_capacity: int = 8192,  # see DeviceStreamingSession for the
        max_groups: int = 128,       # measured-headroom sizing of these
        max_baselines_per_group: int = 192,
        n_beams: int = 64,
        mesh=None,
        collect_paths=None,   # (spec, dict_args) from make_paths_spec
        emit_capacity: int = 0,
    ):
        import jax

        self.config = config or PipelineConfig()
        self.n_streams = int(n_streams)
        self.chunk_bytes = int(chunk_bytes)
        if self.chunk_bytes <= CARRY_BYTES:
            raise ValueError("chunk_bytes must exceed the 10-byte carry")
        self._gcap = int(group_capacity)
        self._mg = int(max_groups)
        self._mbpg = int(max_baselines_per_group)
        self._n_beams = int(n_beams)
        self.mesh = mesh
        cap = frame_capacity(self.chunk_bytes, self.config.decode)
        if collect_paths is not None:
            import jax.numpy as jnp

            spec, dict_args = collect_paths
            self._paths_spec: Optional[StreamPathsSpec] = spec
            self._dict_args = tuple(jnp.asarray(a, jnp.float32)
                                    for a in dict_args)
            ga, gd = len(dict_args[2]), len(dict_args[3])
        else:
            self._paths_spec = None
            self._dict_args = ()
            ga = gd = 0
        # Fixed per-stream emit ring (no auto-growth: growth would
        # recompile the shared vmapped program per doubling; size it from
        # the expected per-stream volume — one frame per 11 bytes bounds
        # kept rows).  Overflow flags per stream; stream_filtered raises.
        self._ecap = int(emit_capacity)
        emit_alloc = (self._ecap + self._gcap + (-(-self.chunk_bytes // 11))
                      if self._ecap else 0)
        kernel = _multi_tracker_kernel(mesh)
        self._step = _build_multi_step(
            cap, self._gcap, max_groups, max_baselines_per_group,
            self.config, self._paths_spec, self._ecap, kernel)
        self._flush = _build_multi_flush(
            max_groups, max_baselines_per_group, self.config,
            self._paths_spec, self._ecap, kernel)

        self._init_key = (self._gcap, n_beams, emit_alloc,
                          self._paths_spec, ga, gd)
        init1 = _build_init(*self._init_key)
        state = jax.vmap(lambda _: init1())(np.arange(self.n_streams))
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            def shard(x):
                spec = P("data", *([None] * (x.ndim - 1)))
                return jax.device_put(x, NamedSharding(mesh, spec))

            state = jax.tree.map(shard, state)
        self._state = state
        self._byte_carry = [np.zeros(0, np.uint8)
                            for _ in range(self.n_streams)]
        self._finalized = False
        self._stream_finalized = np.zeros(self.n_streams, bool)
        self._paths_host = None   # host memo of the online-paths state
        self._emit_host = None    # host memo of the emit rings

    def feed(self, chunks) -> None:
        """Advance every stream by one chunk (``chunks``: S byte buffers;
        use b"" for streams with no new data this round)."""
        import jax

        if self._finalized:
            raise RuntimeError(
                "session already finalized: the flush closed every "
                "stream's open sweep group; start (or restore) a "
                "non-finalized session")
        self._paths_host = None
        self._emit_host = None
        import jax.numpy as jnp

        if len(chunks) != self.n_streams:
            raise ValueError(f"expected {self.n_streams} chunks")
        c = self.chunk_bytes
        bufs, offs = [], []
        for i, chunk in enumerate(chunks):
            if isinstance(chunk, (bytes, bytearray)):
                chunk = np.frombuffer(chunk, dtype=np.uint8)
            chunk = np.asarray(chunk, np.uint8)
            if len(chunk) and self._stream_finalized[i]:
                raise RuntimeError(
                    f"stream {i} already finalized: its flush closed the "
                    "open sweep group, so feeding more bytes would "
                    "mis-segment sweeps (pass b'' for ended streams)")
            bufs.append(np.concatenate([self._byte_carry[i], chunk]))
            offs.append(0)
        # Drain every stream's buffer in lockstep window rounds (same
        # 10-byte-overlap windows as the single-stream session); streams
        # with no window left pass an empty piece — a provable no-op (no
        # new rows, no boundary, carry compaction is the identity).
        while any(len(b) - o > CARRY_BYTES for b, o in zip(bufs, offs)):
            pieces = np.zeros((self.n_streams, c), np.uint8)
            lens = np.zeros((self.n_streams,), np.int32)
            for i in range(self.n_streams):
                n, off = len(bufs[i]), offs[i]
                if n - off > CARRY_BYTES:
                    piece = bufs[i][off:off + c]
                    pieces[i, : len(piece)] = piece
                    lens[i] = len(piece)
                    offs[i] = min(off + c, n) - CARRY_BYTES
            p_dev = jnp.asarray(pieces)
            l_dev = jnp.asarray(lens)
            if self.mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                p_dev = jax.device_put(
                    p_dev, NamedSharding(self.mesh, P("data", None)))
                l_dev = jax.device_put(
                    l_dev, NamedSharding(self.mesh, P("data")))
            self._state = self._step(self._state, p_dev, l_dev,
                                     self._dict_args)
        for i in range(self.n_streams):
            self._byte_carry[i] = bufs[i][offs[i]:].copy()

    def _masked_flush(self, mask: np.ndarray) -> None:
        import jax
        import jax.numpy as jnp

        m_dev = jnp.asarray(mask)
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            m_dev = jax.device_put(
                m_dev, NamedSharding(self.mesh, P("data")))
        self._state = self._flush(self._state, m_dev, self._dict_args)
        for i in np.nonzero(mask)[0]:
            self._byte_carry[i] = np.zeros(0, np.uint8)
        self._paths_host = None
        self._emit_host = None

    def finalize_streams(self, indices) -> None:
        """Flush the open sweep group of the given streams only.

        Live feeds end independently — a capture that stops must close
        its final sweep (and run its last online-estimation step) while
        the other streams keep advancing.  Finalized streams stay in the
        vmapped state as provable no-ops (feed them b""); feeding them
        real bytes raises.
        """
        idx = np.atleast_1d(np.asarray(indices, dtype=np.int64))
        if idx.size == 0:
            return
        if np.any((idx < 0) | (idx >= self.n_streams)):
            raise ValueError(f"stream indices {idx} out of range")
        already = idx[self._stream_finalized[idx]]
        if already.size:
            raise RuntimeError(f"streams {already.tolist()} already "
                               "finalized")
        # Byte carries are <= 10 bytes here (feed drains every full
        # window) — too short for an 11-byte frame, same as the
        # single-stream finalize.
        mask = np.zeros(self.n_streams, bool)
        mask[idx] = True
        self._masked_flush(mask)
        self._stream_finalized |= mask
        if bool(self._stream_finalized.all()):
            self._finalized = True

    def finalize(self) -> None:
        """Flush every stream still open (end of all streams)."""
        if self._finalized:
            return
        remaining = ~self._stream_finalized
        if remaining.any():
            self._masked_flush(remaining)
        self._stream_finalized[:] = True
        self._finalized = True

    def reset_streams(self, indices) -> None:
        """Return finalized slots to the zero state so NEW live feeds can
        attach (the other half of the ragged lifecycle: feeds not only end
        independently — replacements arrive).  Only finalized streams may
        reset: resetting a live stream would silently discard its open
        sweep; finalize it first (its results must be read before the
        reset — the slot's rings are zeroed).
        """
        import jax
        import jax.numpy as jnp

        idx = np.atleast_1d(np.asarray(indices, dtype=np.int64))
        if idx.size == 0:
            return
        if np.any((idx < 0) | (idx >= self.n_streams)):
            raise ValueError(f"stream indices {idx} out of range")
        live = idx[~self._stream_finalized[idx]]
        if live.size:
            raise RuntimeError(
                f"streams {live.tolist()} are still live; finalize_streams"
                " them (and read their results) before resetting")
        mask = np.zeros(self.n_streams, bool)
        mask[idx] = True
        m_dev = jnp.asarray(mask)
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            m_dev = jax.device_put(
                m_dev, NamedSharding(self.mesh, P("data")))
        self._state = _build_multi_reset(*self._init_key)(self._state,
                                                          m_dev)
        for i in idx:
            self._byte_carry[i] = np.zeros(0, np.uint8)
        self._stream_finalized[idx] = False
        self._finalized = False
        self._paths_host = None
        self._emit_host = None

    def _paths_read_all(self):
        """ONE transfer of the whole [S, ...] online-paths state (memoized
        on the host until the next feed/finalize, so per-stream readers do
        not each pay the full device-to-host copy)."""
        import jax

        if self._paths_spec is None:
            raise ValueError("built without collect_paths")
        if self._paths_host is not None:
            return self._paths_host
        p = self._state.paths
        host = jax.device_get((p.n_closed, p.overflow, p.est_rings,
                               p.valid_ring, p.time_ring, p.trk_aoa,
                               p.trk_aod, p.trk_pow, p.trk_obs,
                               p.trk_created, p.trk_count,
                               self._state.overflow))
        if bool(np.any(np.asarray(host[1]))):
            bad = np.nonzero(np.asarray(host[1]))[0].tolist()
            raise RuntimeError(
                f"online estimation overflow on streams {bad}: more than "
                f"{self._paths_spec.s_step} sweeps closed in one step or "
                f"more than {self._paths_spec.capacity} sweeps total; "
                "rebuild with larger s_step/capacity")
        if bool(np.any(np.asarray(host[11]))):
            # Same main-state policy as results(): a group/baseline
            # overflow silently mis-corrects the rows feeding the
            # estimator, so the online paths are suspect too.
            import warnings

            bad = np.nonzero(np.asarray(host[11]))[0].tolist()
            msg = (f"MultiStreamingSession capacity exceeded on streams "
                   f"{bad}; online paths/tracks for those streams are "
                   "computed from incomplete corrections")
            warnings.warn(msg, RuntimeWarning, stacklevel=3)
            _LOGGER.warning(msg)
        self._paths_host = host[:11]
        return self._paths_host

    def stream_filtered(self, i: int) -> np.ndarray:
        """Stream ``i``'s corrected rows [N, 4] in stream order (the
        single-stream ``filtered`` contract; requires ``emit_capacity``)."""
        import jax

        if not self._ecap:
            raise ValueError("built with emit_capacity=0")
        if self._emit_host is None:
            self._emit_host = jax.device_get(
                (self._state.emit_buf, self._state.emit_count,
                 self._state.emit_overflow))
        buf, count, ovf = self._emit_host
        if bool(np.asarray(ovf)[i]):
            raise RuntimeError(
                f"emit ring overflowed on stream {i} (emit_capacity="
                f"{self._ecap}); the exported table would be silently "
                "truncated — rebuild with a larger emit_capacity "
                "(counts/grids remain exact)")
        return np.asarray(buf)[i][: int(np.asarray(count)[i])].astype(
            np.int64)

    def stream_paths(self, i: int):
        """Stream ``i``'s online per-sweep estimates: (paths [n, K],
        sweep_valid [n]) — the single-stream ``sweep_paths`` contract."""
        host = self._paths_read_all()
        n = int(np.asarray(host[0])[i])
        est = host[2]
        paths = type(est)(*(np.asarray(x)[i][:n] for x in est))
        return paths, np.asarray(host[3])[i][:n]

    def n_sweeps_closed_all(self) -> np.ndarray:
        """Closed-sweep counts per stream ([S] i64) — ONE small device
        read (no full-state transfer), for live pollers deciding whether
        any stream has new sweeps."""
        import jax

        if self._paths_spec is None:
            raise ValueError("built without collect_paths")
        return np.asarray(jax.device_get(self._state.paths.n_closed),
                          np.int64)

    def stream_track_columns(self, i: int, lo: int, hi: int):
        """Stream ``i``'s track-ring columns for closed sweeps
        ``[lo, hi)``: ``(aoa [m, T], aod, power, observed, raw CLK
        anchors [m])``.

        The incremental read behind the multi-log live ``watch --events``
        feed — transfers O(hi - lo) ring rows of ONE stream, not the
        whole [S, ...] paths state (``_paths_read_all`` is the right
        call for one-shot exports; this is the right one for a poll
        loop).
        """
        import jax

        if self._paths_spec is None:
            raise ValueError("built without collect_paths")
        p = self._state.paths
        ov, a, d, pw, ob, tm = jax.device_get(
            (p.overflow[i], p.trk_aoa[i, lo:hi], p.trk_aod[i, lo:hi],
             p.trk_pow[i, lo:hi], p.trk_obs[i, lo:hi],
             p.time_ring[i, lo:hi]))
        if bool(ov):
            raise RuntimeError(
                f"online estimation overflow on stream {i}: more than "
                f"{self._paths_spec.s_step} sweeps closed in one step or "
                f"more than {self._paths_spec.capacity} sweeps total; "
                "rebuild with larger s_step/capacity")
        return (np.asarray(a, np.float32), np.asarray(d, np.float32),
                np.asarray(pw, np.float32), np.asarray(ob, bool),
                np.asarray(tm, np.int64))

    def stream_tracks(self, i: int):
        """Stream ``i``'s online tracks: (tracks, times, velocities) —
        the single-stream ``path_tracks`` contract."""
        from slam_process_tpu.models.tracking import (
            Tracks,
            track_velocities,
        )
        from slam_process_tpu.utils.timestamps import unwrap_clk_anchors

        host = self._paths_read_all()
        n = int(np.asarray(host[0])[i])
        times_ring, taoa, taod, tpow, tobs, created, count = (
            np.asarray(host[4])[i], np.asarray(host[5])[i],
            np.asarray(host[6])[i], np.asarray(host[7])[i],
            np.asarray(host[8])[i], np.asarray(host[9])[i],
            int(np.asarray(host[10])[i]))
        tracks = Tracks(taoa[:n].T.copy(), taod[:n].T.copy(),
                        tpow[:n].T.copy(), tobs[:n].T.copy(),
                        created, count)
        t = unwrap_clk_anchors(times_ring[:n].astype(np.int64), _LOGGER)
        return tracks, t, track_velocities(tracks, t)

    def results(self):
        """One transfer: per-stream (n_frames, n_kept, n_groups, sums,
        counts, overflow) numpy arrays with leading S axis.

        Same overflow policy as the single-stream session's result
        reads: when any stream exceeded a static bound (its aggregates
        have silently merged sweeps / dropped baselines), warn loudly
        instead of letting a caller that skips the ``overflow`` element
        consume corrupt results.
        """
        import jax

        s = self._state
        out = jax.device_get((s.n_frames, s.n_kept, s.n_groups,
                              s.sums, s.counts, s.overflow))
        if bool(np.any(out[5])):
            import warnings

            bad = np.nonzero(np.asarray(out[5]))[0].tolist()
            msg = (f"MultiStreamingSession capacity exceeded on streams "
                   f"{bad} (group_capacity/max_groups/"
                   "max_baselines_per_group): those streams' results are "
                   "incomplete; rebuild with larger bounds")
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
            _LOGGER.warning(msg)
        return out

    # -- checkpoint / resume ---------------------------------------------

    def save_checkpoint(self, path, extra: Optional[dict] = None) -> None:
        """Write all S streams' state to ``path`` (one npz file).

        The mesh itself is not serialized (device topology is a property
        of the restoring process); pass ``mesh=`` to :meth:`restore` to
        re-shard the restored state over the new process's devices.
        """
        meta = {
            "extra": extra,
            "version": _CKPT_VERSION,
            "kind": "multi_stream",
            "config": self.config,
            "n_streams": self.n_streams,
            "chunk_bytes": self.chunk_bytes,
            "group_capacity": self._gcap,
            "max_groups": self._mg,
            "max_baselines_per_group": self._mbpg,
            "n_beams": self._n_beams,
            "ecap": self._ecap,
            "finalized": self._finalized,
            "stream_finalized": np.asarray(self._stream_finalized, bool),
            "paths_spec": self._paths_spec,
            "dict_args": tuple(np.asarray(a) for a in self._dict_args),
            "byte_carry": [np.asarray(b, np.uint8)
                           for b in self._byte_carry],
        }
        _ckpt_write(path, self._state, meta)

    @classmethod
    def restore(cls, path, mesh=None) -> "MultiStreamingSession":
        """Rebuild from :meth:`save_checkpoint`; per-stream results after
        feeding the remainder equal an uninterrupted run exactly."""
        meta, leaves = _ckpt_read(path)
        if meta.get("kind") != "multi_stream":
            raise ValueError(
                f"not a MultiStreamingSession checkpoint: kind="
                f"{meta.get('kind')!r}")
        spec = meta["paths_spec"]
        sess = cls(
            meta["n_streams"],
            config=meta["config"],
            chunk_bytes=meta["chunk_bytes"],
            group_capacity=meta["group_capacity"],
            max_groups=meta["max_groups"],
            max_baselines_per_group=meta["max_baselines_per_group"],
            n_beams=meta["n_beams"],
            mesh=mesh,
            collect_paths=((spec, meta["dict_args"])
                           if spec is not None else None),
            emit_capacity=meta["ecap"],
        )
        sess._finalized = bool(meta["finalized"])
        sess._stream_finalized = np.asarray(
            meta.get("stream_finalized",
                     np.full(meta["n_streams"], meta["finalized"])), bool)
        sess._byte_carry = [np.asarray(b, np.uint8)
                            for b in meta["byte_carry"]]
        place = None
        if mesh is not None:
            import jax
            from jax.sharding import NamedSharding, PartitionSpec as P

            def place(x):
                return jax.device_put(
                    x, NamedSharding(
                        mesh, P("data", *([None] * (x.ndim - 1)))))

        sess._state = _ckpt_swap_state(sess._state, leaves, place=place)
        sess.checkpoint_extra = meta.get("extra")
        return sess


def replay_log_device(
    raw: np.ndarray,
    chunk_bytes: int = 1 << 20,
    config: Optional[PipelineConfig] = None,
    **kwargs,
) -> DeviceStreamingSession:
    """Replay one tokenized log through the device streaming pipeline.

    File replays know the stream length, so emit mode sizes its ring to
    the log up front (one frame per 11 bytes bounds kept rows) — no
    auto-growth recompiles, no overflow possible.
    """
    if kwargs.get("collect_filtered") and "emit_capacity" not in kwargs:
        # Bucketed (64k rows) so logs of similar size share one compiled
        # step (the ring capacity is a static shape).
        need = len(raw) // 11 + 1
        kwargs["emit_capacity"] = -(-need // (1 << 16)) * (1 << 16)
    s = DeviceStreamingSession(config, chunk_bytes=chunk_bytes, **kwargs)
    for off in range(0, len(raw), chunk_bytes):
        s.feed(raw[off : off + chunk_bytes])
    s.finalize()
    return s
