"""Quickest proof that the engine runs on the GPU: the main path, once.

    python chip_smoke.py           # one card: phases 0-4 and the GPU test lane
    python chip_smoke.py --four    # four cards: the sharded paths vs one card

Every phase drives the system through the entry points its users call, on
the generated archive (``io.synth``: 19 captures at the reference archive's
shape, ~1.07 M frames), and compares what comes out with the repository's
own float64 host oracles.  A phase that finds a difference raises, and the
script exits non-zero; nothing is caught.  Each phase prints one line with
what it compared, the largest deviation, compile and wall seconds, the main
program's ``memory_analysis()`` and the device's ``peak_bytes_in_use``.
The last line of stdout is one JSON object naming the device:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Phases (one card):

  lane  the GPU test lane (``pytest -m gpu``) as a child process, before
        this process first touches JAX;
  0     environment: card, power limit, JAX, devices, optional imports,
        and the profiler trace's device plane and line names;
  1     archive: device ``Session`` vs host, the fused bytes->RGBA program
        and device tokenize, against the host decoder/corrector/scene;
  2     estimation: the flagship v1-7 NN-OMP over every session in one
        program, and per-sweep estimation over every sweep, against the
        float64 ``nn_omp_np`` oracle's selection sequence;
  3     streaming: the largest capture through ``DeviceStreamingSession``
        in 1 MiB chunks with online estimation, tracking and the emit ring,
        against the offline ``Session``; a mid-stream checkpoint/restore;
        an 8-stream ``MultiStreamingSession`` with ragged ends vs 8 single
        streams;
  4     CLI: ``cli replay --engine device --paths --changes`` in-process on
        two captures (needs matplotlib for its figures).

``--four`` runs only the multi-card paths and their one-card comparisons:
8 streams over a (4, 1) ``data`` mesh, the sharded session estimator over a
(2, 2) ``data x model`` mesh, and the batched session pipeline over (4, 1).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

# The package must come from this checkout; without it there is nothing
# to run (and the script must not print a result).
from slam_process_tpu.io import synth  # noqa: E402

CHUNK = 1 << 20
WORK = REPO / "build" / "smoke"          # scratch space inside the checkout
SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]


class Ctx:
    """What the phases share: the inputs and what earlier phases made."""

    def __init__(self, workdir: Path, captures, est_overrides=None,
                 multi_streams: int = 8, chunk: int = CHUNK):
        from slam_process_tpu.io.angles import write_angle_map

        self.workdir = Path(workdir)
        self.captures = list(captures)
        self.paths = [synth.write_capture(self.workdir / "archive", c)
                      for c in self.captures]
        self.mapping = write_angle_map(self.workdir / "beam_angle.xlsx")
        self.est = dict(est_overrides or {})
        self.multi_streams = multi_streams
        self.chunk = chunk
        self.sessions = None        # device Sessions from phase 1
        self.stream = None          # phase 3's largest-capture session


def full_ctx(workdir: Path) -> Ctx:
    return Ctx(workdir, synth.archive(seed=0))


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------

def _mem(compiled) -> dict:
    m = compiled.memory_analysis()
    if m is None:
        return {}
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k.replace("_size_in_bytes", ""): int(getattr(m, k, 0) or 0)
            for k in keys}


def _peak() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def report(name: str, t0: float, compared: str, max_dev, compile_s,
           memory: dict) -> None:
    print(f"phase {name} ok | compared: {compared} | max_dev: {max_dev} | "
          f"compile_s: {compile_s:.1f} | wall_s: {time.perf_counter() - t0:.1f}"
          f" | memory: {json.dumps(memory)} | peak_bytes_in_use: {_peak()}",
          flush=True)


def _first_and_second(fn):
    """(result, seconds of the first call minus a second call): the first
    call compiles, the second runs what was compiled."""
    import jax

    t = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t
    t = time.perf_counter()
    jax.block_until_ready(fn())
    return out, max(0.0, first - (time.perf_counter() - t))


def _eq(name: str, a, b) -> None:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or not np.array_equal(a, b, equal_nan=True):
        raise AssertionError(f"{name}: differs ({a.shape} vs {b.shape}; "
                             f"{int(np.sum(a != b)) if a.shape == b.shape else '-'}"
                             " elements)")


# ---------------------------------------------------------------------------
# phase 0: environment
# ---------------------------------------------------------------------------

def smi_line() -> str:
    out = subprocess.run(SMI_QUERY, capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip()


def phase_environment(require_gpu: bool = True) -> dict:
    import importlib.util

    import jax
    import jax.numpy as jnp

    t0 = time.perf_counter()
    devs = jax.devices()
    print(f"jax {jax.__version__} devices {devs}", flush=True)
    optional = {m: importlib.util.find_spec(m) is not None
                for m in ("pandas", "matplotlib")}
    print(f"optional imports: {json.dumps(optional)}", flush=True)
    if require_gpu and devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {devs[0]}")

    from slam_process_tpu.utils.cache import enable_persistent_cache

    print(f"compile cache: {enable_persistent_cache()}", flush=True)
    f = jax.jit(lambda x: jnp.tanh(x @ x).sum())
    x = jnp.ones((256, 256), jnp.float32)
    _, compile_s = _first_and_second(lambda: f(x))
    planes = {}
    WORK.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=WORK) as d:
        with jax.profiler.trace(d):
            jax.block_until_ready(f(x))
        from jax.profiler import ProfileData

        from slam_process_tpu.utils.device_timing import module_device_times

        for pb in Path(d).rglob("*.xplane.pb"):
            for plane in ProfileData.from_file(str(pb)).planes:
                planes[plane.name] = sorted({ln.name for ln in plane.lines})
        mods = module_device_times(d) if require_gpu else {}
    print(f"trace planes: {json.dumps(planes)}", flush=True)
    if require_gpu and not mods:
        raise AssertionError("the trace reader found no module on the card")
    report("0-environment", t0, f"trace planes read; device modules "
           f"{sorted(mods)}", 0.0, compile_s, _mem(f.lower(x).compile()))
    return optional


# ---------------------------------------------------------------------------
# phase 1: archive
# ---------------------------------------------------------------------------

def _raster_oracle(filtered):
    from slam_process_tpu.config import SceneConfig
    from slam_process_tpu.ops.raster import blur_nan_aware_np, shifted_log_norm
    from slam_process_tpu.ops.scene import fill_grid, intensity_grid_np

    cfg = SceneConfig(keep_nan=True, fill_with_min=False)
    grid = intensity_grid_np(filtered[:, 0], filtered[:, 1], filtered[:, 2],
                             cfg=cfg)
    return np.asarray(shifted_log_norm(blur_nan_aware_np(fill_grid(grid, cfg).T,
                                                         1.0)))


def phase_archive(ctx: Ctx) -> None:
    import jax

    from slam_process_tpu.io import read_hex_log
    from slam_process_tpu.ops.correct import correct_frames_np
    from slam_process_tpu.ops.scene import intensity_grid_np
    from slam_process_tpu.pipeline.device import (
        bucket_size,
        compiled_session_pipeline,
        pad_bytes,
        run_session_from_text,
        run_session_on_device,
    )
    from slam_process_tpu.pipeline.session import Session

    t0 = time.perf_counter()
    compile_s, max_raster, flips, n_frames = 0.0, 0.0, 0, 0
    sessions = []
    for cap, path in zip(ctx.captures, ctx.paths):
        raw = read_hex_log(path)
        out, c = _first_and_second(lambda: run_session_on_device(raw))
        compile_s += c
        (n, frames, fv, corrected, keep, counts, norm_t,
         overflow) = jax.device_get((out.n_frames, out.frames,
                                     out.frame_valid, out.corrected_bs,
                                     out.keep, out.counts, out.norm_t,
                                     out.correct_overflow))
        if bool(overflow):
            raise AssertionError(f"{cap.name}: corrector bounds exceeded")
        fv = fv.astype(bool)
        host = Session.from_log(path, engine="host")
        res = correct_frames_np(host.frames)
        _eq(f"{cap.name} frames", frames[fv], host.frames)
        _eq(f"{cap.name} frames vs planted", host.frames, cap.frames)
        _eq(f"{cap.name} keep", keep[fv], res.keep)
        _eq(f"{cap.name} corrected", corrected[fv][res.keep],
            res.corrected_bs[res.keep])
        grid = intensity_grid_np(res.filtered[:, 0], res.filtered[:, 1],
                                 res.filtered[:, 2])
        _eq(f"{cap.name} counts", counts, grid.counts)
        oracle = _raster_oracle(res.filtered)
        ours = np.asarray(norm_t, np.float64)
        both = np.isfinite(oracle) & np.isfinite(ours)
        _eq(f"{cap.name} raster NaN mask", np.isfinite(ours),
            np.isfinite(oracle))
        dev = float(np.max(np.abs(ours[both] - oracle[both]), initial=0.0))
        if dev > 1e-3:
            raise AssertionError(f"{cap.name}: raster deviates {dev:.2e}")
        max_raster = max(max_raster, dev)
        flips += int(np.sum(np.minimum((ours[both] * 256).astype(int), 255)
                            != np.minimum((oracle[both] * 256).astype(int),
                                          255)))
        # The device Session (the user entry point) must not take its host
        # fallback, and must equal the host Session.
        dsess = Session.from_log(path, engine="device")
        if "device_pipeline" not in dsess.timings:
            raise AssertionError(f"{cap.name}: device Session fell back "
                                 "to the host")
        _eq(f"{cap.name} device Session filtered", dsess.filtered,
            res.filtered)
        # Device tokenize: the fused text program equals the byte program.
        text = run_session_from_text(Path(path).read_bytes())
        if not bool(text.tokenize_regular):
            raise AssertionError(f"{cap.name}: device tokenize fell back")
        tn, tk, tc = jax.device_get((text.out.n_frames, text.out.n_kept,
                                     text.out.counts))
        _eq(f"{cap.name} text n_frames", tn, n)
        _eq(f"{cap.name} text n_kept", tk, int(res.keep.sum()))
        _eq(f"{cap.name} text counts", tc, grid.counts)
        n_frames += int(n)
        sessions.append(dsess)
    ctx.sessions = sessions
    raw = read_hex_log(ctx.paths[-1])
    nb = bucket_size(len(raw))
    import jax.numpy as jnp

    from slam_process_tpu.ops.raster import colormap_lut

    mem = _mem(compiled_session_pipeline(nb, 1.0, True, 256, 256).lower(
        jnp.asarray(pad_bytes(raw, nb)), jnp.int32(len(raw)),
        jnp.asarray(colormap_lut("viridis"))).compile())
    report("1-archive", t0,
           f"{len(sessions)} captures, {n_frames} frames: frames/keep/"
           f"corrected/counts exact, raster vs f64 (colormap-bin flips "
           f"{flips}), device tokenize", f"{max_raster:.3e}", compile_s, mem)


# ---------------------------------------------------------------------------
# phase 2: estimation
# ---------------------------------------------------------------------------

def _nearest(truth_aoa, truth_aod, aoa, aod) -> float:
    if len(aoa) == 0:
        return float("inf")
    return float(np.min(np.hypot(aoa - truth_aoa, aod - truth_aod)))


def phase_estimation(ctx: Ctx) -> None:
    from slam_process_tpu.config import DictionaryConfig, OmpConfig, SceneConfig
    from slam_process_tpu.io.angles import load_angle_lut
    from slam_process_tpu.models.batch_estimation import (
        _batched_nn_omp_fn,
        estimate_sessions,
        flavor_config,
        pack_scenes,
    )
    from slam_process_tpu.models.dictionary import make_dictionary
    from slam_process_tpu.models.nn_omp import nn_omp_np
    from slam_process_tpu.models.registry import build_scene
    from slam_process_tpu.ops.correct import detect_groups_np
    from slam_process_tpu.ops.scene import intensity_grid_np
    from slam_process_tpu.pipeline.session import sweep_paths_dataset

    t0 = time.perf_counter()
    sessions = ctx.sessions
    dict_cfg, cfg, log_t, keep_rule, stop_np = flavor_config("v1-7",
                                                             **ctx.est)
    tc = time.perf_counter()
    got = estimate_sessions(sessions, ctx.mapping, flavor="v1-7", **ctx.est)
    compile_s = time.perf_counter() - tc
    max_rel, dists, n_sel = 0.0, [], 0
    mats, dicts = [], []
    for s, cap, g in zip(sessions, ctx.captures, got):
        matrix, ue_ang, bs_ang = build_scene(s, ctx.mapping, log_t)
        d = make_dictionary(ue_ang, bs_ang, dict_cfg)
        mats.append(matrix)
        dicts.append(d)
        ref = nn_omp_np(d, matrix, cfg, keep_rule=keep_rule,
                        stop_nonpositive=stop_np)
        n = int(ref.n_iters)
        _eq(f"{s.name} n_iters", int(g.n_iters), n)
        _eq(f"{s.name} aoa_idx", g.aoa_idx[:n], ref.aoa_idx[:n])
        _eq(f"{s.name} aod_idx", g.aod_idx[:n], ref.aod_idx[:n])
        _eq(f"{s.name} valid", g.valid, ref.valid)
        # Powers: f32 NNLS refit on the card vs the f64 oracle; the Gram
        # systems (K <= 20 atoms) are well conditioned, so 2e-3 relative
        # bounds the f32 rounding of the solve.
        p_ref = ref.power[:n]
        rel = np.abs(g.power[:n] - p_ref) / np.maximum(np.abs(p_ref), 1e-6)
        max_rel = max(max_rel, float(np.max(rel, initial=0.0)))
        if max_rel > 2e-3:
            raise AssertionError(f"{s.name}: power rel dev {max_rel:.2e}")
        n_sel += n
        v = np.asarray(ref.valid, bool)
        for p in range(cap.truth.aoa.shape[1]):
            if cap.truth.gain[0, p] > 0:
                dists.append(_nearest(cap.truth.aoa[0, p], cap.truth.aod[0, p],
                                      ref.aoa[v], ref.aod[v]))
    packed = pack_scenes(mats, dicts)
    mem = _mem(_batched_nn_omp_fn(cfg, keep_rule, stop_np).lower(
        packed.matrices, packed.phi_rx, packed.phi_tx, packed.aoa_grid,
        packed.aod_grid).compile())
    print(f"planted vs recovered (session paths, sweep 0 truth): median "
          f"{np.median(dists):.2f} deg, max {np.max(dists):.2f} deg over "
          f"{len(dists)} planted paths", flush=True)

    # Per-sweep estimation over every sweep of every session.
    tc = time.perf_counter()
    per = sweep_paths_dataset(sessions, ctx.mapping)
    compile_s += time.perf_counter() - tc
    lut = load_angle_lut(ctx.mapping)
    sweep_cfg = OmpConfig(max_paths=3)
    sweep_dict = DictionaryConfig(grid_res=0.1, beam_width=1.4,
                                  grid_kind="linspace")
    n_sweeps = 0
    for s, (paths, sweep_valid) in zip(sessions, per):
        f = s.filtered
        gid = detect_groups_np(f[:, 0])
        g_all = intensity_grid_np(f[:, 0], f[:, 1], f[:, 2], cfg=SceneConfig())
        ue_ids = np.nonzero(np.asarray(g_all.row_mask) & np.isfinite(lut))[0]
        bs_ids = np.nonzero(np.asarray(g_all.col_mask) & np.isfinite(lut))[0]
        d = make_dictionary(lut[ue_ids], lut[bs_ids], sweep_dict)
        for sw in range(int(gid.max()) + 1):
            rows = f[gid == sw]
            g = intensity_grid_np(rows[:, 0], rows[:, 1], rows[:, 2],
                                  cfg=SceneConfig())
            sub = np.asarray(g.mean)[np.ix_(ue_ids, bs_ids)]
            fin = np.isfinite(sub)
            _eq(f"{s.name} sweep {sw} valid", bool(sweep_valid[sw]),
                bool(fin.any()))
            if not fin.any():
                continue
            sub = np.where(fin, sub, sub[fin].min())
            ref = nn_omp_np(d, sub, sweep_cfg, keep_rule="positive",
                            stop_nonpositive=False)
            n = int(ref.n_iters)
            _eq(f"{s.name} sweep {sw} aoa_idx",
                np.asarray(paths.aoa_idx[sw])[:n], ref.aoa_idx[:n])
            _eq(f"{s.name} sweep {sw} aod_idx",
                np.asarray(paths.aod_idx[sw])[:n], ref.aod_idx[:n])
            n_sweeps += 1
    report("2-estimation", t0,
           f"v1-7 NN-OMP over {len(sessions)} sessions in one program "
           f"({n_sel} selections) + per-sweep over {n_sweeps} sweeps: "
           "selection sequences exact vs f64 nn_omp_np; powers rtol 2e-3",
           f"{max_rel:.3e}", compile_s, mem)


# ---------------------------------------------------------------------------
# phase 3: streaming
# ---------------------------------------------------------------------------

def _replay(raw, spec, chunk, stop=None, **kw):
    from slam_process_tpu.parallel.streaming_device import (
        DeviceStreamingSession,
    )

    s = DeviceStreamingSession(chunk_bytes=chunk, collect_paths=spec,
                               collect_filtered=True, **kw)
    end = len(raw) if stop is None else stop
    for off in range(0, end, chunk):
        s.feed(raw[off:min(off + chunk, end)])
    if stop is None:
        s.finalize()
    return s


def _paths_tracks(s):
    paths, valid = s.sweep_paths()
    tracks, times, vel = s.path_tracks()
    return paths, valid, tracks, times, vel


def _eq_streams(tag, a, b) -> None:
    pa, va, ta, ta_t, _ = a
    pb, vb, tb, tb_t, _ = b
    _eq(f"{tag} sweep valid", va, vb)
    for name in pb._fields:
        _eq(f"{tag} paths.{name}", getattr(pa, name), getattr(pb, name))
    _eq(f"{tag} track times", ta_t, tb_t)
    for name in ("pos_aoa", "pos_aod", "power", "observed", "created"):
        _eq(f"{tag} tracks.{name}", getattr(ta, name), getattr(tb, name))


def phase_streaming(ctx: Ctx) -> None:
    from slam_process_tpu.io import read_hex_log
    from slam_process_tpu.ops.correct import correct_frames_np
    from slam_process_tpu.ops.decode import decode_frames_np
    from slam_process_tpu.parallel.streaming_device import (
        MultiStreamingSession,
        make_paths_spec,
        replay_log_device,
    )
    from slam_process_tpu.pipeline.session import Session

    t0 = time.perf_counter()
    big = int(np.argmax([len(c.frames) for c in ctx.captures]))
    raw = read_hex_log(ctx.paths[big])
    spec = make_paths_spec(ctx.mapping)
    chunk = ctx.chunk
    tc = time.perf_counter()
    s = _replay(raw, spec, chunk)
    s.block_until_ready()
    compile_s = time.perf_counter() - tc
    ctx.stream = (big, s)

    frames = decode_frames_np(raw).frames
    _eq("stream filtered", s.filtered, correct_frames_np(frames).filtered)
    off = Session("offline")
    off.frames = frames
    ids = (spec[0].ue_ids, spec[0].bs_ids)
    opaths, ovalid = off.sweep_paths(ctx.mapping, beam_ids=ids)
    otracks, otimes, ovel = off.path_tracks(ctx.mapping, beam_ids=ids)
    live = _paths_tracks(s)
    _eq_streams("stream vs offline", live,
                (opaths, ovalid, otracks, otimes, ovel))

    # Checkpoint mid-stream, restore, resume: identical to uninterrupted.
    half = (len(raw) // 2 // chunk) * chunk or chunk
    first = _replay(raw, spec, chunk, stop=half)
    with tempfile.TemporaryDirectory(dir=ctx.workdir) as d:
        ck = Path(d) / "stream.ckpt"
        first.save_checkpoint(ck)
        resumed = type(first).restore(ck)
    for o in range(half, len(raw), chunk):
        resumed.feed(raw[o:o + chunk])
    resumed.finalize()
    _eq("resumed filtered", resumed.filtered, s.filtered)
    _eq_streams("resumed vs uninterrupted", _paths_tracks(resumed), live)

    # Ragged multi-stream: each stream finalizes in the round its bytes end.
    n = min(ctx.multi_streams, len(ctx.captures))
    order = np.argsort([len(c.frames) for c in ctx.captures])[:n]
    raws = [read_hex_log(ctx.paths[i]) for i in order]
    ecap = max(len(r) for r in raws) // 11 + 1
    ms = MultiStreamingSession(n, chunk_bytes=chunk, collect_paths=spec,
                               emit_capacity=ecap)
    rounds = [-(-len(r) // chunk) for r in raws]
    for k in range(max(rounds)):
        ms.feed([r[k * chunk:(k + 1) * chunk] for r in raws])
        ended = [i for i in range(n) if rounds[i] == k + 1]
        if ended and k + 1 < max(rounds):
            ms.finalize_streams(ended)
    ms.finalize()
    nf, nk, ng, sums, counts, ovf = ms.results()
    if np.asarray(ovf).any():
        raise AssertionError("multi-stream overflow")
    for i, r in enumerate(raws):
        ref = replay_log_device(r, chunk_bytes=chunk, collect_paths=spec,
                                collect_filtered=True, emit_capacity=ecap)
        _eq(f"multi[{i}] n_frames", nf[i], int(ref._state.n_frames))
        _eq(f"multi[{i}] sums", sums[i], ref._state.sums)
        _eq(f"multi[{i}] counts", counts[i], ref._state.counts)
        _eq(f"multi[{i}] filtered", ms.stream_filtered(i), ref.filtered)
        pa, va = ms.stream_paths(i)
        ta, tta, va_vel = ms.stream_tracks(i)
        _eq_streams(f"multi[{i}]", (pa, va, ta, tta, va_vel),
                    _paths_tracks(ref))
    import jax.numpy as jnp

    mem = _mem(s._step.lower(s._state, jnp.zeros((chunk,), jnp.uint8),
                             jnp.int32(0), s._dict_args).compile())
    report("3-streaming", t0,
           f"{len(frames)}-frame capture in {chunk}-byte chunks (filtered rows, "
           f"{int(np.sum(live[1]))} sweep paths, tracks) == offline Session; "
           f"checkpoint at byte {half} resumes identically; {n} ragged "
           "streams == single streams", 0, compile_s, mem)


# ---------------------------------------------------------------------------
# phase 4: CLI
# ---------------------------------------------------------------------------

def phase_cli(ctx: Ctx, have_matplotlib: bool) -> None:
    from slam_process_tpu.io.schemas import read_filtered_table
    from slam_process_tpu.io.xlsx import read_xlsx_table
    from slam_process_tpu.parallel.streaming_device import make_paths_spec
    from slam_process_tpu.pipeline.cli import main
    from slam_process_tpu.utils import extract_timestamp

    t0 = time.perf_counter()
    if not have_matplotlib:
        print("phase 4-cli not run: matplotlib absent", flush=True)
        return
    big, _ = ctx.stream
    pick = [big, int(np.argmin([len(c.frames) for c in ctx.captures]))]
    out = ctx.workdir / "cli"
    argv = ["replay", "--logs", *(str(ctx.paths[i]) for i in pick),
            "--mapping", str(ctx.mapping), "--outdir", str(out),
            "--engine", "device", "--paths", "--changes",
            "--chunk-bytes", str(ctx.chunk)]
    rc = main(argv)
    if rc != 0:
        raise AssertionError(f"cli replay returned {rc}")
    spec = make_paths_spec(ctx.mapping)
    for i in pick:
        from slam_process_tpu.io import read_hex_log

        s = _replay(read_hex_log(ctx.paths[i]), spec, ctx.chunk)
        name = extract_timestamp(str(ctx.paths[i])) or ctx.paths[i].stem
        _eq(f"cli {name} filtered",
            read_filtered_table(out / f"{name}_filtered.xlsx"), s.filtered)
        tracks, times, _ = s.path_tracks()
        _, tab = read_xlsx_table(out / f"{name}_stream_tracks.xlsx")
        rows = [(t, sw, times[sw], tracks.pos_aoa[t][sw],
                 tracks.pos_aod[t][sw], tracks.power[t][sw])
                for t in range(int(tracks.n_tracks))
                for sw in np.nonzero(tracks.observed[t])[0]]
        _eq(f"cli {name} tracks", np.asarray(tab)[:, :6],
            np.asarray(rows, np.float64).reshape(-1, 6))
        if not (out / f"{name}_stream_changes.xlsx").exists():
            raise AssertionError(f"cli {name}: no change-event table")
        if not (out / f"{name}_replay.png").exists():
            raise AssertionError(f"cli {name}: no figure")
    report("4-cli", t0, f"cli replay on {len(pick)} captures: filtered and "
           "track tables == streaming session; change tables and figures "
           "written", 0, 0.0, {})


# ---------------------------------------------------------------------------
# --four: the sharded paths vs one card
# ---------------------------------------------------------------------------

def _shard_devices(x) -> list:
    return sorted({sh.device.id for sh in x.addressable_shards})


def phase_four(ctx: Ctx, n_dev: int = 4) -> None:
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.io import read_hex_log
    from slam_process_tpu.models.batch_estimation import (
        _batched_nn_omp_fn,
        flavor_config,
        nn_omp_sessions_sharded,
        pack_scenes,
    )
    from slam_process_tpu.models.dictionary import make_dictionary
    from slam_process_tpu.models.registry import build_scene
    from slam_process_tpu.ops.raster import colormap_lut
    from slam_process_tpu.parallel.batch import (
        batched_session_pipeline,
        stack_sessions,
    )
    from slam_process_tpu.parallel.mesh import make_mesh
    from slam_process_tpu.parallel.streaming_device import (
        MultiStreamingSession,
        make_paths_spec,
    )
    from slam_process_tpu.pipeline.session import Session

    if len(jax.devices()) < n_dev:
        raise SystemExit(f"--four needs {n_dev} devices, have "
                         f"{len(jax.devices())}")
    t0 = time.perf_counter()
    one = make_mesh((1, 1), devices=jax.devices()[:1])

    # 8 streams over a (4, 1) data mesh vs one device.
    n = 2 * n_dev
    raws = [read_hex_log(ctx.paths[i % len(ctx.paths)]) for i in range(n)]
    spec = make_paths_spec(ctx.mapping)
    ecap = max(len(r) for r in raws) // 11 + 1

    chunk = ctx.chunk

    def multi(mesh):
        ms = MultiStreamingSession(n, chunk_bytes=chunk, collect_paths=spec,
                                   emit_capacity=ecap, mesh=mesh)
        for k in range(max(-(-len(r) // chunk) for r in raws)):
            ms.feed([r[k * chunk:(k + 1) * chunk] for r in raws])
        ms.finalize()
        return ms

    tc = time.perf_counter()
    m4 = multi(make_mesh((n_dev, 1)))
    compile_s = time.perf_counter() - tc
    m1 = multi(one)
    held = _shard_devices(jax.tree.leaves(m4._state)[0])
    for a, b, what in zip(m4.results(), m1.results(),
                          ("n_frames", "n_kept", "n_groups", "sums",
                           "counts", "overflow")):
        _eq(f"4-card multi {what}", a, b)
    for i in range(n):
        _eq(f"4-card multi[{i}] filtered", m4.stream_filtered(i),
            m1.stream_filtered(i))
        pa, va = m4.stream_paths(i)
        ta, tta, vel_a = m4.stream_tracks(i)
        pb, vb = m1.stream_paths(i)
        tb, ttb, vel_b = m1.stream_tracks(i)
        _eq_streams(f"4-card multi[{i}]", (pa, va, ta, tta, vel_a),
                    (pb, vb, tb, ttb, vel_b))
    print(f"four: multi-stream state shards on devices {held}", flush=True)

    # Sharded session estimator over (2, 2) data x model vs one device.
    dict_cfg, cfg, log_t, keep_rule, stop_np = flavor_config("v1-7",
                                                             **ctx.est)
    sessions = []
    for p in ctx.paths:
        s = Session.from_log(p)
        s.correct()
        sessions.append(s)
    mats, dicts = [], []
    for s in sessions:
        matrix, ue_ang, bs_ang = build_scene(s, ctx.mapping, log_t)
        mats.append(matrix)
        dicts.append(make_dictionary(ue_ang, bs_ang, dict_cfg))
    packed = pack_scenes(mats, dicts)
    mesh22 = make_mesh((n_dev // 2, 2), ("data", "model"))
    sh = nn_omp_sessions_sharded(packed, cfg, mesh22, keep_rule, stop_np)
    held_est = _shard_devices(jax.tree.leaves(sh)[0])
    ref = _batched_nn_omp_fn(cfg, keep_rule, stop_np)(
        packed.matrices, packed.phi_rx, packed.phi_tx, packed.aoa_grid,
        packed.aod_grid)
    sh, ref = jax.device_get((sh, ref))
    for name in ("n_iters", "aoa_idx", "aod_idx", "valid"):
        _eq(f"4-card estimator {name}", getattr(sh, name), getattr(ref, name))
    pw_dev = float(np.max(np.abs(sh.power - ref.power)
                          / np.maximum(np.abs(ref.power), 1e-6)))
    print(f"four: sharded estimator inputs on devices {held_est}; power max "
          f"rel dev vs one card {pw_dev:.3e}", flush=True)

    # Batched session pipeline over (4, 1) vs one device.
    raws = [read_hex_log(p) for p in ctx.paths]
    n_pad = max(len(r) for r in raws)
    n_pad = -(-n_pad // chunk) * chunk
    n_sess = -(-len(raws) // n_dev) * n_dev
    raws += [np.zeros(0, np.uint8)] * (n_sess - len(raws))
    batch, lengths = stack_sessions(raws, n_pad)
    lut = jnp.asarray(colormap_lut("viridis"))

    def batched(mesh):
        from jax.sharding import NamedSharding, PartitionSpec as P

        fn = batched_session_pipeline(mesh, n_pad, outputs="summary")
        with mesh:
            out = fn(jax.device_put(batch, NamedSharding(mesh, P("data"))),
                     jax.device_put(lengths, NamedSharding(mesh, P("data"))),
                     lut)
        return out

    b4 = batched(make_mesh((n_dev, 1)))
    held_b = _shard_devices(jax.tree.leaves(b4)[0])
    b1 = batched(one)
    b4, b1 = jax.device_get((b4, b1))
    for name in b1._fields:
        _eq(f"4-card batched {name}", getattr(b4, name), getattr(b1, name))
    print(f"four: batched pipeline outputs on devices {held_b}", flush=True)
    report("four", t0, f"{n} streams over ({n_dev},1), sharded NN-OMP over "
           f"(2,2), batched pipeline over ({n_dev},1): bit-identical to one "
           "card (estimator: selection sequences)", f"{pw_dev:.3e}",
           compile_s, {})


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def run_gpu_test_lane() -> None:
    t0 = time.perf_counter()
    # PYTHONPATH: this checkout's ``tests`` package must win over any other
    # installed top-level package of that name.
    env = dict(os.environ, SLAM_PROCESS_TPU_TEST_GPU="1",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [x for x in [os.environ.get("PYTHONPATH")]
                                  if x]))
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q",
         "-p", "no:cacheprovider", "-p", "no:randomly"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    tail = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
    if out.returncode != 0 or "passed" not in tail or "skipped" in tail:
        sys.stdout.write(out.stdout[-6000:])
        sys.stderr.write(out.stderr[-3000:])
        raise SystemExit(f"GPU test lane failed (rc={out.returncode}): {tail}")
    print(f"phase lane ok | compared: pytest -m gpu: {tail} | wall_s: "
          f"{time.perf_counter() - t0:.1f}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths and their one-card "
                         "comparisons")
    args = ap.parse_args(argv)

    # The card's name and power limit (fails without a card).
    smi = smi_line()
    if not args.four:
        run_gpu_test_lane()

    import jax

    print(f"card: {smi}", flush=True)
    optional = phase_environment(require_gpu=True)
    with tempfile.TemporaryDirectory(dir=WORK) as d:
        ctx = full_ctx(Path(d))
        if args.four:
            phase_four(ctx)
        else:
            phase_archive(ctx)
            phase_estimation(ctx)
            phase_streaming(ctx)
            phase_cli(ctx, optional["matplotlib"])
    print(f"card: {smi}", flush=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
