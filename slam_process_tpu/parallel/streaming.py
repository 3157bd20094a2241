"""Streaming replay: chunked real-time decode -> correct -> render.

The reference slurps whole log files (SURVEY.md section 5.7); deployment
streams are unbounded, so this module processes byte chunks incrementally
with exact offline-parity semantics:

  * decode carry: a frame can straddle a chunk boundary.  By the >=11-byte
    spacing theorem, positions with a full 11-byte window are accepted or
    rejected definitively, so the carry is exactly the last
    ``min(10, bytes after the last emitted frame)`` bytes — the only
    positions whose verdict can change with more data.
  * correction granularity: a row's correction depends on every baseline in
    its sweep group, so rows are buffered until the group closes (UE
    decrease), then corrected and folded into the running intensity
    accumulators.  Per-cell means are sum/count, hence order-independent
    and equal to the offline pivot.

The device-side counterpart is parallel/streaming_device.py (the same
state machine as one jitted step).  tests/test_streaming.py proves chunked == offline byte-for-byte
on real logs at multiple chunk sizes.
"""

from __future__ import annotations

import functools
from typing import Iterator, Optional, Union

import numpy as np

from slam_process_tpu.config import PipelineConfig, SceneConfig
from slam_process_tpu.ops.correct import correct_frames_np
from slam_process_tpu.ops.decode import extract_fields, frame_start_mask
from slam_process_tpu.ops.scene import IntensityGrid
from slam_process_tpu.utils import get_logger

_LOGGER = get_logger("slam_process_tpu.streaming")


@functools.lru_cache(maxsize=8)
def _host_sweep_estimator(est_key):
    """The SAME estimator body the device/offline paths run, jitted for
    per-closed-sweep [1, U, B] calls (lane results are batch-size
    invariant, so a batch of one equals the offline [S, U, B] lanes)."""
    import jax

    from slam_process_tpu.models.sweep_estimation import sweep_estimator_body

    run_all = sweep_estimator_body(est_key)

    def f(sub, phi_rx, phi_tx, aoa_g, aod_g):
        with jax.default_matmul_precision("highest"):
            return run_all(sub, phi_rx, phi_tx, aoa_g, aod_g)

    return jax.jit(f)


def _cpu_execution_scope():
    """Scope for the host engine's estimator dispatch: execute on the
    CPU backend even in a process whose default backend is an
    accelerator.

    Two reasons: (a) this class's contract is "streaming without an
    accelerator" — the estimator must not silently land on the card;
    (b) the batch-1 GEMM NaN-padding parity rationale in
    ``_p_close_sweep`` is a property of XLA's CPU backend.  In a
    CPU-pinned process (the CLI's host-engine commands pin
    ``jax_platforms=cpu``, and so does the test suite) this scope is the
    default already.  In a process that is NOT pinned, the device query
    below initializes every backend, so the accelerator's runtime starts
    and reserves its memory; that is why the CLI pins the platform list
    up front instead of relying on this scope.
    """
    import contextlib

    import jax

    try:
        dev = jax.local_devices(backend="cpu")[0]
    except Exception:   # pragma: no cover — no cpu backend registered
        return contextlib.nullcontext()
    return jax.default_device(dev)


class StreamingSession:
    """Host-engine streaming session.

    ``collect_paths`` (a ``(spec, dict_args)`` pair from
    ``parallel.streaming_device.make_paths_spec``) arms ONLINE per-sweep
    estimation + CLK anchoring, mirroring the device engine's
    ``DeviceStreamingSession(collect_paths=...)``: kept rows segment into
    sweeps incrementally (UE decrease, carried across chunks), each sweep
    that closes runs the per-sweep estimator immediately, and memory
    stays O(closed sweeps) — no kept-row history is needed.  Results
    (``sweep_paths``/``sweep_times``/``path_tracks``) equal the offline
    flagship exactly (tests/test_streaming_paths.py).
    """

    def __init__(self, config: Optional[PipelineConfig] = None,
                 n_beams: int = 64, collect_paths=None):
        self.config = config or PipelineConfig()
        self._carry = np.zeros(0, dtype=np.uint8)
        self._group_rows: list[np.ndarray] = []   # frames of the open sweep
        self._last_ue: Optional[int] = None
        self.n_frames = 0
        self.n_kept = 0
        self.n_groups = 0
        self.filtered_parts: list[np.ndarray] = []
        nb = n_beams
        self._sums = np.zeros((nb, nb))
        self._counts = np.zeros((nb, nb), dtype=np.int64)
        self._finalized = False
        if collect_paths is not None:
            spec, dict_args = collect_paths
            self._paths_spec = spec
            self._dict_args = tuple(np.asarray(a, np.float32)
                                    for a in dict_args)
            self._p_open_sums = np.zeros((nb, nb), np.float32)
            self._p_open_counts = np.zeros((nb, nb), np.float32)
            self._p_open_time = -1
            self._p_last_ue = -1
            self._p_est: list = []     # per-closed-sweep estimator outputs
            self._p_valid: list = []
            self._p_times: list = []
            # Incremental tracker (track_columns): lazily advanced from
            # the _p_est history, so checkpoints need no extra state.
            t_n = spec.max_tracks
            self._trk_pos = np.zeros((t_n, 2), np.float32)
            self._trk_created = np.zeros(t_n, bool)
            self._trk_count = 0
            self._trk_cols: list = []  # per-sweep (aoa, aod, pow, obs) [T]
        else:
            self._paths_spec = None
            self._dict_args = ()

    # -- ingest --------------------------------------------------------------

    def feed(self, chunk: Union[bytes, np.ndarray]) -> int:
        """Consume one chunk of tokenized bytes; returns frames decoded."""
        if self._finalized:
            raise RuntimeError(
                "session already finalized: the flush closed the open "
                "sweep group, so feeding more bytes would mis-segment "
                "sweeps; start (or restore) a non-finalized session")
        if isinstance(chunk, (bytes, bytearray)):
            chunk = np.frombuffer(chunk, dtype=np.uint8)
        buf = np.concatenate([self._carry, np.asarray(chunk, dtype=np.uint8)])
        n = len(buf)
        ok = frame_start_mask(buf, self.config.decode)
        starts = np.nonzero(ok)[0]
        frames = (extract_fields(buf, starts) if starts.size
                  else np.zeros((0, 5), np.int64))

        # Carry: suffix that may still become a frame with more data.
        last_end = int(starts[-1]) + self.config.decode.frame_len if starts.size else 0
        carry_start = max(n - (self.config.decode.frame_len - 1), last_end)
        self._carry = buf[carry_start:].copy()

        self.n_frames += len(frames)
        self._push_frames(frames)
        return len(frames)

    def _push_frames(self, frames: np.ndarray) -> None:
        """Vectorized sweep segmentation: split the chunk's frames at UE
        decreases, close every completed group, buffer the open tail."""
        if not len(frames):
            return
        ue = frames[:, 1]
        boundary = np.zeros(len(frames), dtype=bool)
        boundary[0] = self._last_ue is not None and ue[0] < self._last_ue
        boundary[1:] = ue[:-1] > ue[1:]
        cuts = np.nonzero(boundary)[0]
        start = 0
        for cut in cuts:
            if cut > start:
                self._group_rows.append(frames[start:cut])
            self._correct_and_fold_open()
            start = int(cut)
        self._group_rows.append(frames[start:])
        self._last_ue = int(ue[-1])

    def _correct_and_fold_open(self) -> None:
        if not self._group_rows:
            return
        group = np.concatenate(self._group_rows)
        self._group_rows = []
        if not len(group):
            return
        self.n_groups += 1
        res = correct_frames_np(group, self.config.correct)
        if len(res.filtered):
            self.filtered_parts.append(res.filtered)
            self.n_kept += len(res.filtered)
            if self._paths_spec is not None:
                self._paths_push(res.filtered)
            ue = res.filtered[:, 0]
            bs = res.filtered[:, 1]
            rss = res.filtered[:, 2].astype(np.float64)
            if self.config.scene.log_transform:
                # v1-7 pre-log semantics: drop RSS<=0, fold ln(RSS), so the
                # streaming accumulators equal the offline pivot's mean(ln).
                pos = rss > 0
                ue, bs, rss = ue[pos], bs[pos], np.log(rss[pos])
            np.add.at(self._sums, (ue, bs), rss)
            np.add.at(self._counts, (ue, bs), 1)

    # -- online per-sweep estimation (host engine) -------------------------

    def _paths_push(self, rows: np.ndarray) -> None:
        """Segment this fold's kept rows into sweeps (UE decrease, seeded
        with the carry ``_p_last_ue``) and estimate every sweep that
        closes — same boundary rule as the device step's kept-row scan."""
        ue = rows[:, 0]
        prev = np.concatenate([[self._p_last_ue], ue[:-1]])
        bnd = (prev >= 0) & (prev > ue)
        start = 0
        for cut in np.nonzero(bnd)[0]:
            self._p_accumulate(rows[start:cut])
            self._p_close_sweep()
            start = int(cut)
        self._p_accumulate(rows[start:])
        self._p_last_ue = int(ue[-1])

    def _p_accumulate(self, rows: np.ndarray) -> None:
        if not len(rows):
            return
        if self._p_open_time < 0:
            self._p_open_time = int(rows[0, 3])
        np.add.at(self._p_open_sums, (rows[:, 0], rows[:, 1]),
                  rows[:, 2].astype(np.float32))
        np.add.at(self._p_open_counts, (rows[:, 0], rows[:, 1]),
                  np.float32(1))

    def _p_close_sweep(self) -> None:
        """Run the per-sweep estimator on the closed sweep's mean grid
        (f32 sums/counts — exact integer sums, the device formulation).

        The call pads the single sweep to an 8-lane NaN batch (the device
        step's block size): XLA's CPU backend dispatches batch-1 GEMMs
        through a different reduction order than batched ones, which
        costs ~1 f32 ulp vs the offline [S]-batch — lane results ARE
        bitwise batch-size invariant for batch >= 2 (verified), so the
        padded call restores exact offline parity.  NaN lanes produce
        invalid outputs that are sliced off.
        """
        import jax

        spec = self._paths_spec
        counts = self._p_open_counts
        mean = np.where(counts > 0,
                        self._p_open_sums / np.maximum(counts,
                                                       np.float32(1.0)),
                        np.float32(np.nan)).astype(np.float32)
        sub = mean[np.ix_(list(spec.ue_ids), list(spec.bs_ids))]
        padded = np.full((8,) + sub.shape, np.nan, np.float32)
        padded[0] = sub
        with _cpu_execution_scope():
            est, valid = jax.device_get(_host_sweep_estimator(spec.est_key)(
                padded, *self._dict_args))
        est = type(est)(*(np.asarray(x)[:1] for x in est))
        valid = np.asarray(valid)[:1]
        self._p_est.append(est)
        self._p_valid.append(np.asarray(valid))
        self._p_times.append(self._p_open_time)
        self._p_open_sums[:] = 0
        self._p_open_counts[:] = 0
        self._p_open_time = -1

    def sweep_paths(self):
        """Online per-sweep estimates: (paths [n_closed, K], sweep_valid)
        — the ``DeviceStreamingSession.sweep_paths`` contract; equals the
        offline ``Session.sweep_paths`` on the same stream exactly."""
        if self._paths_spec is None:
            raise ValueError("built without collect_paths")
        if not self._p_est:
            import jax

            # No sweeps closed: derive the empty-but-correctly-shaped
            # structure from one estimator call on an all-NaN grid.
            spec = self._paths_spec
            u, b = len(spec.ue_ids), len(spec.bs_ids)
            nan = np.full((8, u, b), np.nan, np.float32)
            with _cpu_execution_scope():
                est, valid = jax.device_get(
                    _host_sweep_estimator(spec.est_key)(nan,
                                                        *self._dict_args))
            paths = type(est)(*(np.asarray(x)[:0] for x in est))
            return paths, np.asarray(valid)[:0]
        est0 = self._p_est[0]
        paths = type(est0)(*(
            np.concatenate([np.asarray(getattr(e, f)) for e in self._p_est])
            for f in est0._fields))
        return paths, np.concatenate(self._p_valid)

    def sweep_times(self):
        """CLK anchors of the closed sweeps, unwrapped like the offline
        ``Session.sweep_times`` (shared helper)."""
        from slam_process_tpu.utils.timestamps import unwrap_clk_anchors

        if self._paths_spec is None:
            raise ValueError("built without collect_paths")
        return unwrap_clk_anchors(np.asarray(self._p_times, np.int64),
                                  _LOGGER)

    def path_tracks(self):
        """Online CLK-anchored tracks — the offline ``Session.path_tracks``
        contract, from the incrementally estimated sweeps."""
        from slam_process_tpu.models.tracking import (
            track_paths_np,
            track_velocities,
        )

        spec = self._paths_spec
        paths, sweep_valid = self.sweep_paths()
        times = self.sweep_times()
        power = paths.power if hasattr(paths, "power") else paths.metric
        valid = (np.asarray(paths.valid, bool)
                 & sweep_valid[:, None] & (times >= 0)[:, None])
        tracks = track_paths_np(paths.aoa, paths.aod, power, valid,
                                max_tracks=spec.max_tracks,
                                gate_deg=spec.gate_deg)
        return tracks, times, track_velocities(tracks, times)

    def track_columns(self, lo: int, hi: int):
        """Per-sweep track columns for closed sweeps ``[lo, hi)``:
        ``(aoa [m, T], aod, power, observed, raw CLK anchors [m])``.

        The incremental read behind the live ``watch --events`` feed.
        Columns come from the SAME association step batch
        ``path_tracks`` runs (``track_sweep_step_np``), advanced lazily
        over the stored per-sweep estimates and cached — so repeated
        polls cost O(new sweeps), and the streamed columns equal the
        batch ``Tracks`` tensors column-for-column (restore replays the
        checkpointed history through the same step).
        """
        from slam_process_tpu.models.tracking import track_sweep_step_np

        spec = self._paths_spec
        if spec is None:
            raise ValueError("built without collect_paths")
        n = len(self._p_times)
        lo, hi = max(int(lo), 0), min(int(hi), n)
        gate2 = np.float32(spec.gate_deg) * np.float32(spec.gate_deg)
        while len(self._trk_cols) < hi:
            s = len(self._trk_cols)
            est = self._p_est[s]
            # Same per-sweep inputs batch path_tracks derives: power (or
            # metric), path-valid & sweep-valid & anchored (unwrapped
            # anchors are >= 0 exactly where raw anchors are).
            aoa_s = np.asarray(est.aoa, np.float32)[0]
            aod_s = np.asarray(est.aod, np.float32)[0]
            pw = est.power if hasattr(est, "power") else est.metric
            pow_s = np.asarray(pw, np.float32)[0]
            valid_s = (np.asarray(est.valid, bool)[0]
                       & bool(self._p_valid[s][0])
                       & (int(self._p_times[s]) >= 0))
            self._trk_count, ca, cd, cp, co = track_sweep_step_np(
                self._trk_pos, self._trk_created, self._trk_count,
                aoa_s, aod_s, pow_s, valid_s, gate2)
            self._trk_cols.append((ca, cd, cp, co))
        cols = self._trk_cols[lo:hi]
        t_n = spec.max_tracks
        if not cols:
            z = np.zeros((0, t_n), np.float32)
            return (z, z.copy(), z.copy(), np.zeros((0, t_n), bool),
                    np.zeros(0, np.int64))
        return (np.stack([c[0] for c in cols]),
                np.stack([c[1] for c in cols]),
                np.stack([c[2] for c in cols]),
                np.stack([c[3] for c in cols]),
                np.asarray(self._p_times[lo:hi], np.int64))

    @property
    def n_sweeps_closed(self) -> int:
        if self._paths_spec is None:
            raise ValueError("built without collect_paths")
        return len(self._p_times)

    def finalize(self) -> None:
        """Flush the open sweep group (end of stream)."""
        if self._finalized:
            return
        self._correct_and_fold_open()
        if (self._paths_spec is not None
                and float(self._p_open_counts.sum()) > 0):
            self._p_close_sweep()
        self._last_ue = None
        self._finalized = True

    # -- checkpoint / resume ---------------------------------------------

    def save_checkpoint(self, path, extra: Optional[dict] = None) -> None:
        """Write the full host streaming state to ``path`` (one npz file).

        The host-engine counterpart of ``DeviceStreamingSession.
        save_checkpoint`` (same atomic-replace file discipline, same
        ``extra`` side-channel for the caller's cursor); resume equals an
        uninterrupted run exactly (tests/test_checkpoint.py).
        """
        import os
        import pickle

        group = (np.concatenate(self._group_rows) if self._group_rows
                 else np.zeros((0, 5), np.int64))
        meta = {
            "version": 1,
            "kind": "host_stream",
            "config": self.config,
            "last_ue": self._last_ue,
            "n_frames": self.n_frames,
            "n_kept": self.n_kept,
            "n_groups": self.n_groups,
            "finalized": self._finalized,
            "extra": extra,
            "paths_spec": self._paths_spec,
            "dict_args": tuple(self._dict_args),
            "paths_state": (None if self._paths_spec is None else {
                "open_sums": self._p_open_sums,
                "open_counts": self._p_open_counts,
                "open_time": self._p_open_time,
                "last_ue": self._p_last_ue,
                "est": self._p_est,
                "valid": self._p_valid,
                "times": self._p_times,
            }),
        }
        blob = np.frombuffer(pickle.dumps(meta, protocol=4), np.uint8)
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, meta=blob, carry=self._carry, sums=self._sums,
                     counts=self._counts, group=group,
                     filtered=self.filtered)
        os.replace(tmp, path)

    @classmethod
    def restore(cls, path) -> "StreamingSession":
        """Rebuild a session from :meth:`save_checkpoint` output."""
        import pickle

        with np.load(path, allow_pickle=False) as z:
            meta = pickle.loads(z["meta"].tobytes())
            if meta.get("kind") != "host_stream":
                raise ValueError(
                    f"not a StreamingSession checkpoint: kind="
                    f"{meta.get('kind')!r} (device-engine checkpoints "
                    "restore via DeviceStreamingSession.restore)")
            if meta.get("version") != 1:
                raise ValueError(
                    f"unsupported checkpoint version {meta.get('version')!r}")
            carry, sums, counts, group, filtered = (
                z["carry"], z["sums"], z["counts"], z["group"],
                z["filtered"])
        spec = meta.get("paths_spec")
        sess = cls(config=meta["config"], n_beams=sums.shape[0],
                   collect_paths=((spec, meta["dict_args"])
                                  if spec is not None else None))
        if spec is not None:
            ps = meta["paths_state"]
            sess._p_open_sums = np.asarray(ps["open_sums"], np.float32)
            sess._p_open_counts = np.asarray(ps["open_counts"], np.float32)
            sess._p_open_time = int(ps["open_time"])
            sess._p_last_ue = int(ps["last_ue"])
            sess._p_est = list(ps["est"])
            sess._p_valid = list(ps["valid"])
            sess._p_times = list(ps["times"])
        sess._carry = np.asarray(carry, np.uint8)
        sess._sums = np.asarray(sums, np.float64)
        sess._counts = np.asarray(counts, np.int64)
        sess._group_rows = [np.asarray(group, np.int64)] if len(group) else []
        sess._last_ue = meta["last_ue"]
        sess.n_frames = int(meta["n_frames"])
        sess.n_kept = int(meta["n_kept"])
        sess.n_groups = int(meta["n_groups"])
        sess.filtered_parts = ([np.asarray(filtered, np.int64)]
                               if len(filtered) else [])
        sess._finalized = bool(meta["finalized"])
        sess.checkpoint_extra = meta.get("extra")
        return sess

    # -- results -------------------------------------------------------------

    @property
    def filtered(self) -> np.ndarray:
        if not self.filtered_parts:
            return np.zeros((0, 4), dtype=np.int64)
        return np.concatenate(self.filtered_parts)

    def intensity(self) -> IntensityGrid:
        from slam_process_tpu.ops.scene import grid_from_sums_np

        return grid_from_sums_np(self._sums, self._counts)

    def render(self, angle_lut: np.ndarray, render_cfg=None):
        from slam_process_tpu.config import RenderConfig
        from slam_process_tpu.render.heatmap import render_intensity

        return render_intensity(
            self.intensity(), angle_lut,
            SceneConfig(keep_nan=True, fill_with_min=False),
            render_cfg or RenderConfig(),
        )


def replay_log(raw: np.ndarray, chunk_bytes: int = 1 << 16,
               config: Optional[PipelineConfig] = None,
               render_every: int = 0, angle_lut: Optional[np.ndarray] = None,
               collect_paths=None,
               ) -> StreamingSession:
    """Replay one tokenized log through the streaming pipeline."""
    s = StreamingSession(config, collect_paths=collect_paths)
    n_chunks = 0
    for off in range(0, len(raw), chunk_bytes):
        s.feed(raw[off : off + chunk_bytes])
        n_chunks += 1
        if render_every and angle_lut is not None and n_chunks % render_every == 0:
            s.render(angle_lut)
    s.finalize()
    return s


def iter_chunks(raw: np.ndarray, chunk_bytes: int) -> Iterator[np.ndarray]:
    for off in range(0, len(raw), chunk_bytes):
        yield raw[off : off + chunk_bytes]
