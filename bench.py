"""Benchmark: archive decode+correct+render throughput on one device.

Runs the fused on-device session pipeline (bytes -> frames -> corrected ->
intensity -> raster) over every capture of the generated archive
(``io.synth.archive``, the reference dataset's shape) and prints a JSON
result line:

    {"metric": "frames_per_sec_decode_correct_render", "value": N,
     "unit": "frames/s", "vs_baseline": N, ...}

vs_baseline is measured against BASELINE.json's north-star target of
10,000 frames/s for a full-session decode+render (the reference itself
publishes no numbers; its pure-Python decode loop is timed on this host,
see "reference_frames_per_sec" in extras).  Also reports the max
premultiplied-RGBA pixel delta between the device raster and the float64
matplotlib-oracle render path (budget 1e-3).

Device-side numbers come from the jax.profiler trace's device plane
(utils/device_timing.py); ``*_wall_s`` extras are host wall clocks around
``block_until_ready``.  A backend without a device plane (the CPU) makes
the device lanes fail: no CPU number is reported under a device key.

The result line is re-printed after every lane (each a superset of the
previous).  A wall-clock budget (env ``BENCH_BUDGET_S``, default 600)
skips the remaining lanes once exceeded and marks ``"truncated": true``.
A failed lane is recorded under ``lane_errors`` and makes the process
exit non-zero.  Per-lane markers and package logging go to stderr;
stdout carries only JSON result lines.

This script is due to be rebuilt as cells x metrics (ROADMAP A1).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np

BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "600"))


def _oracle_norm_raster(filtered: np.ndarray) -> np.ndarray:
    """Float64 host oracle for the normalized (pre-colormap) raster.

    The continuous parity surface is the [0,1]-normalized data raster:
    colormap application quantizes to 256 LUT bins, so two renders whose t
    values differ by 1e-7 near a bin edge legitimately differ by a full
    viridis step (~0.01) in RGBA — exactly as two matplotlib runs at
    different float precision would.  Pixel parity is therefore measured on
    t (budget 1e-3) with LUT-bin agreement reported alongside.
    """
    from slam_process_tpu.config import SceneConfig
    from slam_process_tpu.ops.raster import blur_nan_aware_np, shifted_log_norm
    from slam_process_tpu.ops.scene import fill_grid, intensity_grid_np

    cfg = SceneConfig(keep_nan=True, fill_with_min=False)
    grid = intensity_grid_np(filtered[:, 0], filtered[:, 1], filtered[:, 2], cfg=cfg)
    matrix = fill_grid(grid, cfg).T
    return np.asarray(shifted_log_norm(blur_nan_aware_np(matrix, 1.0)))


class Reporter:
    """Keeps the result dict and re-prints it as a JSON line after every
    lane, so the tail of stdout always ends in the most complete valid
    result."""

    def __init__(self) -> None:
        self.t0 = time.perf_counter()
        self.result = {
            "metric": "frames_per_sec_decode_correct_render",
            "value": 0.0,
            "unit": "frames/s",
            "vs_baseline": 0.0,
            "stage": "init",
        }
        self.lane_seconds: dict = {}
        self.skipped: list = []
        self.errors: dict = {}
        self._lock = threading.Lock()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def over_budget(self) -> bool:
        return self.elapsed() > BUDGET_S

    def note(self, msg: str) -> None:
        print(f"bench: [t={self.elapsed():7.1f}s] {msg}", file=sys.stderr,
              flush=True)

    def emit(self, stage: str) -> None:
        with self._lock:
            self.result["stage"] = stage
            self.result["elapsed_wall_s"] = round(self.elapsed(), 1)
            if self.lane_seconds:
                self.result["lane_seconds"] = {
                    k: round(v, 2) for k, v in self.lane_seconds.items()}
            if self.skipped:
                self.result["truncated"] = True
                self.result["skipped_lanes"] = list(self.skipped)
            if self.errors:
                self.result["lane_errors"] = dict(self.errors)
            print(json.dumps(self.result), flush=True)

class Bench:
    """The lane runner.  Lanes execute in order; each is budget-gated,
    exception-isolated, and followed by a fresh result emission."""

    def __init__(self, rep: Reporter) -> None:
        self.rep = rep
        self.r = rep.result

    # ------------------------------------------------------------------
    # Lane 0: backend selection + dataset load + host frame count.
    # ------------------------------------------------------------------
    def lane_setup(self) -> None:
        import jax

        from slam_process_tpu.utils.cache import enable_persistent_cache

        enable_persistent_cache()
        from slam_process_tpu.io import read_hex_log
        from slam_process_tpu.ops.decode import decode_frames_np
        from slam_process_tpu.pipeline.device import run_session_on_device as _run

        self.logs = [str(p) for p in _archive_logs()]
        self.raw = [read_hex_log(p) for p in self.logs]
        # Host-side decode once: frames reused by the estimator-prep and
        # parity lanes, and the count anchors the provisional headline.
        self.host_frames = {}
        total = 0
        for i in range(len(self.raw)):
            self.host_frames[i] = decode_frames_np(self.raw[i]).frames
            total += len(self.host_frames[i])
        self.total_frames = total
        self.r["total_frames"] = total
        self.r["n_logs"] = len(self.logs)
        self.r["backend"] = jax.default_backend()

        # Archive-tight corrector bounds (at most 58 groups and 4% of a
        # ~4.2k-frame sweep as baselines — io/synth.py): the corrector's
        # [F, Bmax] score planes scale with the static bounds.  Matches the
        # batched config below.
        self.run_session_on_device = (
            lambda r: _run(r, max_groups=64, max_baselines_per_group=192))

        from slam_process_tpu.parallel.mesh import make_mesh

        self.mesh = make_mesh((1, 1), ("data", "model"))
        # The biggest session (used by the single-session device-vs-host
        # comparison lanes, which run in either order).
        self.big_idx = int(np.argmax([len(r) for r in self.raw]))

    # ------------------------------------------------------------------
    # Lane 1: warmup — compile every per-session bucket once.
    # ------------------------------------------------------------------
    def lane_warmup(self) -> None:
        import jax

        warm = []
        for i, r in enumerate(self.raw):
            warm.append(self.run_session_on_device(r))
        jax.block_until_ready([o.rgba for o in warm])
        del warm
        self.r["device"] = str(jax.devices()[0])

    # ------------------------------------------------------------------
    # Phase 1 — WALL lanes (host clock around block_until_ready).
    # ------------------------------------------------------------------
    def lane_wall_headline(self) -> None:
        import jax

        t0 = time.perf_counter()
        outs = [self.run_session_on_device(r) for r in self.raw]
        jax.block_until_ready([(o.rgba, o.n_frames) for o in outs])
        self.headline_wall_s = time.perf_counter() - t0
        self.r["headline_wall_s"] = round(self.headline_wall_s, 4)
        # Provisional headline until the device plane is measured: flagged
        # and superseded by lane_dev_headline.
        self.r["value"] = round(self.total_frames / self.headline_wall_s, 1)
        self.r["vs_baseline"] = round(self.r["value"] / 10_000.0, 3)
        self.r["provisional_wall_based"] = True
        # Keep two sessions for pixel parity; keep tiny per-session scalars
        # for the overflow guard (separate buffers — does not pin siblings).
        self.parity_outs = {i: outs[i] for i in (0, len(self.logs) - 1)}
        self.overflow_flags = [o.correct_overflow for o in outs]

    def lane_wall_e2e(self) -> None:
        import jax

        from slam_process_tpu.io import read_hex_log

        # Fully end-to-end, host-tokenize config: file read + native
        # AVX-512 hexscan (runtime/hexscan.c, ~3.9 GB/s on this core) +
        # H2D of the token bytes + device pipeline.  Single host core
        # (nproc=1): sequential ingest is the honest number.
        t1 = time.perf_counter()
        outs2 = [self.run_session_on_device(read_hex_log(p)) for p in self.logs]
        jax.block_until_ready([o.rgba for o in outs2])
        self.e2e_wall_s = time.perf_counter() - t1
        del outs2
        self.r["e2e_frames_per_sec_with_host_tokenize"] = round(
            self.total_frames / self.e2e_wall_s, 1)

    def lane_wall_e2e_devtok(self) -> None:
        import jax

        # Fully end-to-end, device-tokenize config: file read + stride-3
        # text prep + H2D of the RAW TEXT + fused tokenize+decode+correct+
        # render program (ops/tokenize.py).  3x the H2D bytes buys zero
        # host tokenize time — which path wins depends on the H2D rate.
        from slam_process_tpu.pipeline.device import run_session_from_text

        self.run_session_from_text = run_session_from_text

        def text_pass():
            return [run_session_from_text(open(p, "rb").read(), max_groups=64,
                                          max_baselines_per_group=96,
                                          check=False) for p in self.logs]

        import jax.numpy as jnp

        outs3 = text_pass()   # warm: compile every text bucket
        jax.block_until_ready([o.out.rgba for o in outs3])
        # Aggregate the stride-proof flags on device; read in Phase 2.
        self.tokenize_regular_dev = jax.jit(lambda *xs: sum(xs))(
            *[o.tokenize_regular.astype("int32") for o in outs3])
        t1 = time.perf_counter()
        outs3 = text_pass()
        jax.block_until_ready([o.out.rgba for o in outs3])
        e2e_devtok_wall_s = time.perf_counter() - t1
        del outs3
        self.r["e2e_frames_per_sec_device_tokenize"] = round(
            self.total_frames / e2e_devtok_wall_s, 1)
        self.r["e2e_wall_s_device_tokenize"] = round(e2e_devtok_wall_s, 4)
        self.r["e2e_frames_per_sec"] = round(
            self.total_frames / min(self.e2e_wall_s, e2e_devtok_wall_s), 1)

    def lane_wall_batched(self) -> None:
        import gc

        import jax

        session_axis = "vmap"
        self.r["batched_session_axis"] = session_axis

        gc.collect()
        # Batched-session config: ONE jitted program over the stacked
        # [S, Nmax] byte batch (the multi-chip layout, on a single chip).
        self.bfn, self.batch_np, self.len_np, self.lut_j = _build_batched(
            self.mesh, self.raw, session_axis)
        with self.mesh:
            self.batch_dev = jax.device_put(self.batch_np)
            self.len_dev = jax.device_put(self.len_np)
            bout = self.bfn(self.batch_dev, self.len_dev, self.lut_j)  # warm
            jax.block_until_ready(bout.rgba)
            t3 = time.perf_counter()
            bout = self.bfn(self.batch_dev, self.len_dev, self.lut_j)
            jax.block_until_ready((bout.rgba, bout.n_kept, bout.counts))
            self.r["batched_wall_s"] = round(time.perf_counter() - t3, 4)
            del bout

    def lane_wall_streaming_host(self) -> None:
        # Streaming replay config (BASELINE config 5): chunked ingest with
        # alignment carry + sweep-granular correction, host state machine
        # (pure numpy — a genuine wall measurement, no device work).
        from slam_process_tpu.parallel.streaming import replay_log

        t2 = time.perf_counter()
        frames = sum(replay_log(r, chunk_bytes=1 << 16).n_frames
                     for r in self.raw)
        self.r["streaming_frames_per_sec"] = round(
            frames / (time.perf_counter() - t2), 1)

    def lane_warm_streaming_device(self) -> None:
        import jax

        # Device streaming warm (compile all variants before their windows).
        from slam_process_tpu.parallel.streaming_device import (
            make_paths_spec,
            replay_log_device,
        )

        self.replay_log_device = replay_log_device
        replay_log_device(self.raw[0], chunk_bytes=1 << 20).block_until_ready()
        replay_log_device(self.raw[0], chunk_bytes=1 << 20,
                          collect_filtered=True).block_until_ready()
        # Online estimation + tracking inside the stream (collect_paths).
        self.paths_cfg = make_paths_spec(_angle_map())
        replay_log_device(self.raw[0], chunk_bytes=1 << 20,
                          collect_paths=self.paths_cfg).block_until_ready()

    def lane_est_prep(self) -> None:
        import jax

        # Flagship estimation (the reference's single heaviest compute):
        # v1-7 NN-OMP at the 0.1-degree grid (heatmap_gemini_v1-7.py:657-728).
        from slam_process_tpu.config import DictionaryConfig, OmpConfig
        from slam_process_tpu.models.batch_estimation import (
            _batched_nn_omp_fn,
            nn_omp_sessions_sharded,
            pack_scenes,
        )
        from slam_process_tpu.models.dictionary import make_dictionary
        from slam_process_tpu.models.nn_omp import _jitted_nn_omp
        from slam_process_tpu.models.registry import build_scene
        from slam_process_tpu.pipeline.session import Session

        self.mapping = _angle_map()
        self.est_cfg = OmpConfig(max_paths=20, min_power_ratio=0.0003)
        dict_cfg = DictionaryConfig(grid_res=0.1, beam_width=1.4,
                                    grid_kind="linspace")
        self.est_sessions, self.est_mats, self.est_dicts = [], [], []
        for i, p in enumerate(self.logs):
            s = Session(Path(p).stem)
            s.frames = self.host_frames[i]
            matrix, ue_ang, bs_ang = build_scene(s, self.mapping, True)
            self.est_mats.append(matrix)
            self.est_dicts.append(make_dictionary(ue_ang, bs_ang, dict_cfg))
            self.est_sessions.append(s)
        self.packed = pack_scenes(self.est_mats, self.est_dicts)
        self.single_fn = _jitted_nn_omp(self.est_cfg, "ratio", True)
        self.nn_omp_sessions_sharded = nn_omp_sessions_sharded

        # Async per-session dispatch (adjudication baseline) AND the
        # vmapped one-program path — the device-plane WINNER (26.9 ms with
        # the Gauss-Jordan NNLS solve vs 83 ms async; tools/
        # diag_est_dispatch.py) and the production formulation.
        self.per_dev = [jax.device_put((self.packed.phi_rx[i],
                                        self.packed.phi_tx[i],
                                        self.packed.aoa_grid[i],
                                        self.packed.aod_grid[i],
                                        self.packed.matrices[i]))
                        for i in range(len(self.logs))]
        self.est_out = [self.single_fn(*a) for a in self.per_dev]  # warm
        jax.block_until_ready([o.power for o in self.est_out])
        self.vm_fn = _batched_nn_omp_fn(self.est_cfg, "ratio", True)
        self.vm_args = jax.device_put((self.packed.matrices, self.packed.phi_rx,
                                       self.packed.phi_tx, self.packed.aoa_grid,
                                       self.packed.aod_grid))
        vm_warm = self.vm_fn(*self.vm_args)
        jax.block_until_ready(vm_warm.power)
        del vm_warm
        # Sharded formulation on this chip's (1, 1) mesh: same program XLA
        # compiles for the multi-chip layout (virtual-mesh parity tested).
        sh_warm = nn_omp_sessions_sharded(self.packed, self.est_cfg, self.mesh)
        jax.block_until_ready(sh_warm.power)
        del sh_warm

    def lane_wall_est(self) -> None:
        import jax

        t8 = time.perf_counter()
        outs_e = self.vm_fn(*self.vm_args)
        jax.block_until_ready(outs_e.power)
        self.r["estimate_wall_s_dataset"] = round(time.perf_counter() - t8, 4)
        del outs_e

    def lane_host_est(self) -> None:
        from slam_process_tpu.models.nn_omp import nn_omp_np

        # The reference-shaped float64 host path on the biggest session
        # (scipy NNLS loop — the 0.285 s/session baseline this must beat).
        host_times = []
        for _ in range(3):   # min of 3: the host path inherits CPU noise
            t9 = time.perf_counter()
            self.est_host_paths = nn_omp_np(
                self.est_dicts[self.big_idx], self.est_mats[self.big_idx],
                self.est_cfg, keep_rule="ratio", stop_nonpositive=True)
            host_times.append(time.perf_counter() - t9)
        self.est_host_s = min(host_times)
        self.r["estimate_host_session_seconds"] = round(self.est_host_s, 4)
        if hasattr(self, "est_single_device_s"):
            self.r["estimate_speedup_vs_host"] = round(
                self.est_host_s / self.est_single_device_s, 1)

    # ------------------------------------------------------------------
    # Phase 2 — DEVICE-plane lanes (the authoritative numbers).  Each
    # window performs one D2H read to close it, so these run after every
    # wall section.
    # ------------------------------------------------------------------
    def lane_dev_headline(self) -> None:
        import jax
        import jax.numpy as jnp

        from slam_process_tpu.utils.device_timing import measure_device_time

        self.measure_device_time = measure_device_time
        # One real D2H read BEFORE the first window, so Phase 1's queued
        # device work completes outside it.  The fence is a FRESH trivial
        # program dispatched after everything above — programs execute in
        # dispatch order, so its completion implies the backlog's.
        jax.device_get(jax.jit(lambda: jnp.zeros(()))())

        # Headline: per-session pipeline over the whole dataset (19
        # dispatches of per-bucket executables).  3 passes; per-pass total.
        def pass_all(_i):
            outs = [self.run_session_on_device(r) for r in self.raw]
            return outs[-1].n_kept

        dt_head = measure_device_time(pass_all, n=3)
        headline_device_s = sum(
            sum(v) for v in dt_head.all_modules.values()) / 3
        fps = self.total_frames / headline_device_s
        self.r["value"] = round(fps, 1)
        self.r["vs_baseline"] = round(fps / 10_000.0, 3)
        self.r.pop("provisional_wall_based", None)
        self.r["measurement"] = ("device-plane (xplane) seconds; "
                                 "*_wall_s = dispatch wall")
        self.r["headline_device_seconds_per_pass"] = round(headline_device_s, 4)
        self.r["headline_device_runs"] = len(dt_head.runs)

        # The tight 64/96 corrector bounds are only valid while the dataset
        # fits them: one aggregated read of the Phase-1 overflow flags
        # guards the whole run's numbers (reads are safe in this phase).
        if hasattr(self, "overflow_flags"):
            any_overflow = bool(jax.device_get(jax.jit(
                lambda *xs: sum(x.astype("int32") for x in xs))(
                    *self.overflow_flags)))
            if any_overflow:
                # Invalidate the published headline BEFORE raising: lane
                # isolation records the error but keeps emitting, and an
                # invalid number must never survive as the result value.
                self.r["value"] = 0.0
                self.r["vs_baseline"] = 0.0
                self.r["error"] = ("corrector capacity bounds (64 groups / "
                                   "96 baselines) exceeded by the dataset; "
                                   "headline invalidated")
                raise RuntimeError(self.r["error"])
        else:
            self.r["overflow_guard"] = "not-checked (wall_headline skipped)"

    def lane_dev_text(self) -> None:
        import jax

        # Fused text pipeline (device tokenize): device seconds per pass,
        # and the stride-proof audit (all 19 logs take the device path).
        datas_text = [open(p, "rb").read() for p in self.logs]

        def text_pass_mem(_i):
            outs = [self.run_session_from_text(d, max_groups=64,
                                               max_baselines_per_group=96,
                                               check=False) for d in datas_text]
            return outs[-1].out.n_kept

        dt_text = self.measure_device_time(text_pass_mem, n=3)
        text_device_s = sum(sum(v) for v in dt_text.all_modules.values()) / 3
        self.r["text_pipeline_device_seconds_per_pass"] = round(text_device_s, 4)
        self.r["text_pipeline_device_frames_per_sec"] = round(
            self.total_frames / text_device_s, 1)
        self.r["tokenize_all_regular"] = (
            int(jax.device_get(self.tokenize_regular_dev)) == len(self.logs))

    def lane_dev_batched(self) -> None:
        if not hasattr(self, "bfn"):
            raise RuntimeError("skipped: batched program unavailable "
                               "(wall_batched failed)")
        with self.mesh:
            dt_batched = self.measure_device_time(
                lambda i: self.bfn(self.batch_dev, self.len_dev,
                                   self.lut_j).n_kept, n=3, module="batched")
        self.r["batched_device_seconds_full_dataset"] = round(
            dt_batched.median, 4)
        self.r["batched_device_frames_per_sec"] = round(
            self.total_frames / dt_batched.median, 1)
        self.r["batched_device_trials_s"] = [
            round(t, 4) for t in dt_batched.runs]

    def lane_dev_grouped(self) -> None:
        import jax
        import jax.numpy as jnp

        # Grouped batched (the same multi-chip layout, per-bucket programs
        # — no uniform-padding waste).  Device seconds = sum over the
        # per-bucket programs of one pass.
        from slam_process_tpu.parallel.batch import run_dataset_batched_grouped

        with self.mesh:
            warm_g = run_dataset_batched_grouped(self.mesh, self.raw,
                                                 max_groups=64,
                                                 max_baselines_per_group=96)
            jax.block_until_ready([o.n_kept for _, o in warm_g])
            jax.device_get(jax.jit(lambda: jnp.zeros(()))())   # fence
            dt_grouped = self.measure_device_time(
                lambda i: run_dataset_batched_grouped(
                    self.mesh, self.raw, max_groups=64,
                    max_baselines_per_group=96)[-1][1].n_kept, n=3)
        grouped_device_s = sum(
            sum(v) for v in dt_grouped.all_modules.values()) / 3
        self.r["batched_grouped_device_seconds_full_dataset"] = round(
            grouped_device_s, 4)
        self.r["batched_grouped_device_frames_per_sec"] = round(
            self.total_frames / grouped_device_s, 1)

    def lane_dev_multistream(self) -> None:
        # Multi-stream vmapped ingest (the §5.8 many-concurrent-feeds
        # shape): the 19 logs round-robined over 8 live streams, every step
        # ONE vmapped program over the [S, ...] state (single chip here; on
        # a mesh the S axis shards over 'data' with no cross-chip traffic).
        # Per-stream parity vs independent sessions is tests/
        # test_multidevice.py's job — this measures aggregate throughput.
        from slam_process_tpu.parallel.streaming_device import (
            MultiStreamingSession,
        )

        n_ms_streams = 8
        ms_feeds = [
            np.concatenate(
                [r for j, r in enumerate(self.raw) if j % n_ms_streams == i]
                or [np.zeros(0, np.uint8)])
            for i in range(n_ms_streams)
        ]

        def multistream_all(_i):
            ms = MultiStreamingSession(n_ms_streams, chunk_bytes=1 << 20)
            ms.feed(ms_feeds)
            ms.finalize()
            return ms, ms._state.n_frames

        ms_warm, _ = multistream_all(0)                   # warm/compile
        multistream_frames = int(ms_warm.results()[0].sum())
        assert multistream_frames == self.total_frames, \
            "multistream lost frames"
        dt_ms = self.measure_device_time(lambda i: multistream_all(i)[1], n=1)
        ms_device_s = sum(sum(v) for v in dt_ms.all_modules.values())
        self.r["multistream_n_streams"] = n_ms_streams
        self.r["multistream_frames"] = multistream_frames
        self.r["multistream_device_seconds_full_dataset"] = round(
            ms_device_s, 4)
        self.r["multistream_device_frames_per_sec"] = round(
            multistream_frames / ms_device_s, 1)

    def lane_dev_streaming(self) -> None:
        # Device-resident streaming (no-emit and emit modes): total device
        # seconds across the full dataset replay (many step dispatches).
        def stream_all(_i):
            ss = [self.replay_log_device(r, chunk_bytes=1 << 20)
                  for r in self.raw]
            return ss[-1]._state.n_frames

        dt_stream = self.measure_device_time(stream_all, n=1)
        stream_device_s = sum(sum(v) for v in dt_stream.all_modules.values())
        self.r["streaming_device_seconds_full_dataset"] = round(
            stream_device_s, 4)
        self.r["streaming_device_frames_per_sec"] = round(
            self.total_frames / stream_device_s, 1)

    def lane_dev_streaming_emit(self) -> None:
        def stream_emit_all(_i):
            ss = [self.replay_log_device(r, chunk_bytes=1 << 20,
                                         collect_filtered=True)
                  for r in self.raw]
            return ss[-1]._state.n_frames

        dt_emit = self.measure_device_time(stream_emit_all, n=1)
        emit_device_s = sum(sum(v) for v in dt_emit.all_modules.values())
        self.r["streaming_device_emit_seconds_full_dataset"] = round(
            emit_device_s, 4)
        self.r["streaming_device_emit_frames_per_sec"] = round(
            self.total_frames / emit_device_s, 1)

    def lane_dev_streaming_paths(self) -> None:
        # Streaming with ONLINE per-sweep estimation + tracking: the
        # offline flagship produced in-stream as sweeps close (exact-parity
        # tested against Session.sweep_paths/path_tracks on every log).
        def stream_paths_all(_i):
            ss = [self.replay_log_device(r, chunk_bytes=1 << 20,
                                         collect_paths=self.paths_cfg)
                  for r in self.raw]
            return ss[-1]._state.n_frames

        dt_spaths = self.measure_device_time(stream_paths_all, n=1)
        spaths_device_s = sum(sum(v) for v in dt_spaths.all_modules.values())
        self.r["streaming_with_estimation_seconds_full_dataset"] = round(
            spaths_device_s, 4)
        self.r["streaming_with_estimation_frames_per_sec"] = round(
            self.total_frames / spaths_device_s, 1)

    def lane_dev_estimate(self) -> None:
        # Flagship estimation, three formulations on the device plane:
        # vmapped one-program (production), async per-session (baseline),
        # mesh-sharded (the multi-chip program, here at (1, 1)).
        dt_vm = self.measure_device_time(
            lambda i: self.vm_fn(*self.vm_args).power, n=3)
        est_vm_device_s = sum(sum(v) for v in dt_vm.all_modules.values()) / 3
        self.r["estimate_device_seconds_dataset"] = round(est_vm_device_s, 4)
        self.r["estimate_sessions_per_sec_device"] = round(
            len(self.logs) / est_vm_device_s, 1)

        with self.mesh:
            dt_sh = self.measure_device_time(
                lambda i: self.nn_omp_sessions_sharded(
                    self.packed, self.est_cfg, self.mesh).power, n=3)
        est_sh_device_s = sum(sum(v) for v in dt_sh.all_modules.values()) / 3
        self.r["estimate_sharded_device_seconds_dataset"] = round(
            est_sh_device_s, 4)
        self.r["estimate_sharded_sessions_per_sec_device"] = round(
            len(self.logs) / est_sh_device_s, 1)

    def lane_dev_estimate_async(self) -> None:
        def est_all(_i):
            outs_e = [self.single_fn(*a) for a in self.per_dev]
            return outs_e[-1].power

        dt_est = self.measure_device_time(est_all, n=3)
        est_device_s = sum(sum(v) for v in dt_est.all_modules.values()) / 3
        self.r["estimate_async_device_seconds_dataset"] = round(est_device_s, 4)
        self.r["estimate_async_sessions_per_sec_device"] = round(
            len(self.logs) / est_device_s, 1)
        # The big session's own executions (dispatch order preserved per
        # pass), so the host-vs-device speedup compares the SAME session on
        # both sides; median-across-sessions would understate it.
        n_per_pass = len(dt_est.runs) // 3
        fallback = n_per_pass != len(self.logs)
        if fallback:   # trace dropped/added an event: say so loudly
            self.rep.note(f"WARNING: estimator trace had {len(dt_est.runs)} "
                          f"runs, expected {3 * len(self.logs)}; single-"
                          "session device time falls back to the median")
        big_runs = (sorted(dt_est.runs) if fallback
                    else sorted(dt_est.runs[self.big_idx::n_per_pass]))
        self.est_single_device_s = big_runs[len(big_runs) // 2]
        self.r["estimate_single_session_device_seconds"] = round(
            self.est_single_device_s, 5)
        self.r["estimate_single_session_is_fallback_median"] = fallback
        if hasattr(self, "est_host_s"):
            self.r["estimate_speedup_vs_host"] = round(
                self.est_host_s / self.est_single_device_s, 1)

    # ------------------------------------------------------------------
    # Phase 3 — per-sweep estimation (reads internally), parity, reference.
    # ------------------------------------------------------------------
    def lane_sweep_est(self) -> None:
        import jax.numpy as jnp

        from slam_process_tpu.pipeline.session import sweep_paths_dataset

        for s in self.est_sessions:
            s.correct()
        sweep_paths_dataset(self.est_sessions, self.mapping)   # warm + memo
        times = []
        for _ in range(3):
            t6 = time.perf_counter()
            ds_results = sweep_paths_dataset(self.est_sessions, self.mapping)
            times.append(time.perf_counter() - t6)
        ds_sweep_s = sorted(times)[1]
        ds_n_sweeps = sum(len(v) for _, v in ds_results)
        self.r["sweep_estimation_sweeps_per_sec"] = round(
            ds_n_sweeps / ds_sweep_s, 1)
        self.r["sweep_estimation_n_sweeps"] = ds_n_sweeps

        # Device-plane seconds for the same section (the wall number above
        # includes host prep, 19 dispatches, and the stacked read).
        dt_sweep = self.measure_device_time(
            lambda i: sweep_paths_dataset(self.est_sessions, self.mapping)
            and jnp.zeros(()), n=2)
        ds_sweep_device_s = sum(
            sum(v) for v in dt_sweep.all_modules.values()) / 2
        self.r["sweep_estimation_device_seconds"] = round(ds_sweep_device_s, 4)
        self.r["sweep_estimation_sweeps_per_sec_device"] = round(
            ds_n_sweeps / ds_sweep_device_s, 1)

    def lane_parity(self) -> None:
        from slam_process_tpu.ops.correct import correct_frames_np

        # Pixel parity: device normalized raster vs float64 host oracle,
        # plus colormap LUT-bin agreement.
        t_deltas, bin_flips = [], 0
        for idx in (0, len(self.logs) - 1):
            filtered = correct_frames_np(self.host_frames[idx]).filtered
            oracle_t = _oracle_norm_raster(filtered)
            ours_t = np.asarray(self.parity_outs[idx].norm_t, dtype=np.float64)
            both = np.isfinite(oracle_t) & np.isfinite(ours_t)
            t_deltas.append(float(np.max(np.abs(ours_t[both] - oracle_t[both]))))
            bin_flips += int(
                (np.clip((ours_t[both] * 256).astype(int), 0, 255)
                 != np.clip((oracle_t[both] * 256).astype(int), 0, 255)).sum())
        self.r["max_pixel_delta_norm_raster"] = max(t_deltas)
        self.r["lut_bin_flips"] = bin_flips

    def lane_est_parity(self) -> None:
        import jax

        # Flagship estimation parity: one batched pytree read, then the
        # biggest session's selection sequence must match the float64 host
        # oracle.
        est_host_out = jax.device_get(self.est_out)[self.big_idx]
        n_it = int(self.est_host_paths.n_iters)
        self.r["estimate_parity_ok"] = bool(
            int(est_host_out.n_iters) == n_it
            and np.array_equal(est_host_out.aoa_idx[:n_it],
                               self.est_host_paths.aoa_idx[:n_it])
            and np.array_equal(est_host_out.aod_idx[:n_it],
                               self.est_host_paths.aod_idx[:n_it])
            and np.allclose(est_host_out.power[:n_it],
                            self.est_host_paths.power[:n_it],
                            rtol=2e-3, atol=1e-5))

    def lane_reference(self) -> None:
        # Reference pipeline throughput on this host (tokenize + parse
        # measured on the smallest log; the iterrows correct stage measured
        # on a 4000-row subsample — it dominates; the reference publishes
        # no numbers of its own).
        ref_fps = _reference_pipeline_fps(self.raw[0])
        self.r["reference_frames_per_sec"] = round(ref_fps, 1)
        if not self.r.get("provisional_wall_based"):
            self.r["speedup_vs_reference"] = round(
                self.r["value"] / max(ref_fps, 1e-9), 1)

    # Wall lanes run before the device-plane lanes, whose trace windows
    # each end in a device-to-host read.
    LANES = [
        ("setup", lane_setup),
        ("warmup", lane_warmup),
        ("wall_headline", lane_wall_headline),
        ("wall_e2e", lane_wall_e2e),
        ("wall_e2e_devtok", lane_wall_e2e_devtok),
        ("dev_headline", lane_dev_headline),
        ("dev_text", lane_dev_text),
        ("est_prep", lane_est_prep),
        ("dev_estimate", lane_dev_estimate),
        ("dev_estimate_async", lane_dev_estimate_async),
        ("wall_est", lane_wall_est),
        ("host_est", lane_host_est),
        ("parity", lane_parity),
        ("est_parity", lane_est_parity),
        ("reference", lane_reference),
        ("sweep_est", lane_sweep_est),
        ("wall_streaming_host", lane_wall_streaming_host),
        ("warm_streaming_device", lane_warm_streaming_device),
        ("dev_multistream", lane_dev_multistream),
        ("dev_streaming", lane_dev_streaming),
        ("dev_streaming_emit", lane_dev_streaming_emit),
        ("dev_streaming_paths", lane_dev_streaming_paths),
        ("dev_grouped", lane_dev_grouped),
        ("wall_batched", lane_wall_batched),
        ("dev_batched", lane_dev_batched),
    ]

    # Lanes that later lanes cannot run without; an error or budget-skip
    # here aborts the rest (recorded, never raised out of run()).
    REQUIRED = {"setup", "warmup"}

    def run(self) -> None:
        aborted = False
        for name, fn in self.LANES:
            if aborted or self.rep.over_budget():
                self.rep.skipped.append(name)
                continue
            self.rep.note(f"lane={name} start")
            t0 = time.perf_counter()
            try:
                fn(self)
                self.rep.lane_seconds[name] = time.perf_counter() - t0
                self.rep.note(f"lane={name} done in "
                              f"{self.rep.lane_seconds[name]:.1f}s")
            except Exception as e:   # noqa: BLE001 — lane isolation
                self.rep.lane_seconds[name] = time.perf_counter() - t0
                self.rep.errors[name] = f"{type(e).__name__}: {e}"[:300]
                self.rep.note(f"lane={name} FAILED: {e!r}")
                if name in self.REQUIRED:
                    aborted = True
            self.rep.emit(name)
        self.rep.emit("final")


def _build_batched(mesh, raw, session_axis: str):
    """The batched program + its inputs (lane_wall_batched)."""
    import jax.numpy as jnp

    from slam_process_tpu.ops.raster import colormap_lut
    from slam_process_tpu.parallel.batch import (
        batched_session_pipeline,
        stack_sessions,
    )

    n_padded = max(len(r) for r in raw)
    n_padded = ((n_padded + (1 << 20) - 1) >> 20) << 20
    batch, lengths = stack_sessions(raw, n_padded)
    bfn = batched_session_pipeline(mesh, n_padded, max_groups=64,
                                   max_baselines_per_group=192,
                                   outputs="summary",
                                   session_axis=session_axis)
    return bfn, batch, lengths, jnp.asarray(colormap_lut("viridis"))


def main() -> None:
    # Package INFO logging must not land on stdout between JSON emissions:
    # stdout carries only result lines, everything else goes to stderr.
    logging.basicConfig(stream=sys.stderr, level=logging.INFO)
    rep = Reporter()
    rep.emit("init")   # a valid (zero-value) line exists from second one
    Bench(rep).run()
    if rep.errors:
        sys.exit(1)


def _angle_map() -> Path:
    """The built-in beam-angle table as a mapping .xlsx (io/angles.py)."""
    from slam_process_tpu.io.synth import default_archive

    return default_archive()[1]


def _archive_logs():
    """The generated archive's capture files (written once under build/)."""
    from slam_process_tpu.io.synth import default_archive

    return sorted(default_archive()[0].glob("*.txt"))


def _reference_pipeline_fps(b: np.ndarray) -> float:
    """Measured throughput of the reference's compute path on this host:
    regex tokenizer (serial_hex_to_excel_v3.py:18-36) + per-byte parse loop
    (:41-103) + iterrows correction (bs_beam_correction.py:140-178, measured
    on a 4000-row subsample).  Composes the per-stage rates harmonically."""
    import time as _time

    from slam_process_tpu.io.hexlog import tokenize_hex_reference

    # Stage 1a: tokenize (regex loop).  Reconstruct approximate raw text.
    text = b" ".join(b"%02X" % v for v in b.tolist()[:200_000])
    t0 = _time.perf_counter()
    toks = tokenize_hex_reference(text)
    tok_rate_bytes = len(toks) / (_time.perf_counter() - t0)

    # Stage 1b: parse loop.
    t0 = _time.perf_counter()
    rows = _reference_decode_loop(b)
    parse_rate = len(rows) / (_time.perf_counter() - t0)

    # Stage 2: iterrows correction on a subsample.
    import pandas as pd

    frames = np.asarray(rows[:4000], dtype=np.int64)
    df = pd.DataFrame(frames, columns=["FLAG", "UE", "BS", "RSS", "CLK"])
    CYCLE, TOL, MOD = 61_000, 500, 64
    t0 = _time.perf_counter()
    gid = ((df["UE"].shift(1) > df["UE"]) | df["UE"].shift(1).isna()).cumsum() - 1
    for _g, grp in df.groupby(gid):
        prev_flag = grp["FLAG"].shift(1)
        prev_rss = grp["RSS"].shift(1)
        mask = (grp["FLAG"] == 1) & (prev_flag == 0) & (grp["RSS"] == prev_rss)
        baselines = [
            (int(grp.loc[i - 1, "CLK"]), int(grp.loc[i, "BS"]))
            for i in grp.index[mask]
        ]
        for _i, row in grp.iterrows():
            if row["FLAG"] == 1 or not baselines:
                continue
            clk = int(row["CLK"])
            for clk_b, bs_b in baselines:
                d = clk - clk_b
                k = int(round(d / CYCLE))
                if abs(d - k * CYCLE) <= TOL:
                    _ = (bs_b + k) % MOD
    correct_rate = len(df) / (_time.perf_counter() - t0)

    # frames/s for tokenize: 11 bytes/frame.
    tok_rate = tok_rate_bytes / 11.0
    return 1.0 / (1.0 / tok_rate + 1.0 / parse_rate + 1.0 / correct_rate)


def _reference_decode_loop(b: np.ndarray):
    """A faithful reimplementation of the reference's per-byte Python decode
    loop (serial_hex_to_excel_v3.py:41-103), used only to report the
    baseline's achievable throughput on this host."""
    rows = []
    i, n = 0, len(b)
    bl = b.tolist()
    while i < n:
        flag = bl[i]
        if flag not in (0xCC, 0x33):
            i += 1
            continue
        if i + 11 > n:
            break
        ue, bs = bl[i + 1], bl[i + 2]
        if (ue >> 6) != 0 or (bs >> 6) != 3:
            i += 1
            continue
        clk_bytes = bl[i + 3 : i + 8]
        if any((c >> 6) != 1 for c in clk_bytes):
            i += 1
            continue
        rss_bytes = bl[i + 8 : i + 11]
        if any((r >> 6) != 2 for r in rss_bytes):
            i += 1
            continue
        clk = 0
        for k, c in enumerate(clk_bytes):
            clk |= (c & 0x3F) << (6 * k)
        rss = (rss_bytes[0] & 0x3F) | ((rss_bytes[1] & 0x3F) << 6) | ((rss_bytes[2] & 0x3F) << 12)
        rows.append((1 if flag == 0xCC else 0, ue & 0x3F, bs & 0x3F, rss, clk))
        i += 11
    return rows


if __name__ == "__main__":
    main()
