"""Command-line drivers mirroring the reference scripts' CLIs.

    python -m slam_process_tpu.pipeline.cli decode  IN.txt OUT.xlsx
    python -m slam_process_tpu.pipeline.cli correct --input IN.xlsx [--output OUT]
    python -m slam_process_tpu.pipeline.cli heatmap --input IN.xlsx --mapping beam_angle.xlsx
    python -m slam_process_tpu.pipeline.cli estimate --input FILTERED.xlsx --mapping ... --model nn_omp
    python -m slam_process_tpu.pipeline.cli session --log IN.txt --mapping ... --outdir DIR

Reference CLI surfaces: serial_hex_to_excel_v3.py:122-127 (positional),
bs_beam_correction.py:285-291 (argparse), excel_heatmap.py:544-590
(argparse); the estimator scripts had hard-coded paths (SURVEY.md section
5.6) and gain a real CLI here.
"""

from __future__ import annotations

import argparse
import json
import sys
import zipfile
from pathlib import Path

from slam_process_tpu.config import RenderConfig, SceneConfig
from slam_process_tpu.pipeline.session import Session
from slam_process_tpu.utils import get_logger


def _add_decode(sub):
    p = sub.add_parser("decode", help="hex serial log -> Parsed xlsx (stage 1)")
    p.add_argument("input", type=Path)
    p.add_argument("output", type=Path, nargs="?")
    p.add_argument("--format", choices=["v1", "v2", "v3"], default="v3",
                   help="wire format generation (v3 = 11-byte, current)")
    p.set_defaults(fn=_run_decode)


def _run_decode(args):
    out = args.output or args.input.with_suffix(".xlsx")
    if args.format != "v3":
        _run_decode_legacy(args, out)
        return
    s = Session.from_log(args.input)
    s.export_parsed(out)
    c = s.counters[-1].counts
    print(f"有效组数={c['valid']} 丢弃组数={c['discarded']} 输出={out}")


def _run_decode_legacy(args, out):
    from slam_process_tpu.io import read_hex_log
    from slam_process_tpu.io.xlsx import write_xlsx_mixed
    from slam_process_tpu.ops.decode_legacy import (
        V1_COLUMNS,
        V2_COLUMNS,
        decode_frames_v1_np,
        decode_frames_v2_np,
        to_hex,
    )

    raw = read_hex_log(args.input)
    if args.format == "v1":
        res = decode_frames_v1_np(raw)
        w, f = res.windows, res.frames
        # Reference column layout incl. raw-byte hex strings
        # (serial_hex_to_excel.py:83-110).
        cols = [
            [to_hex(v) for v in w[:, 0]], f[:, 0],
            [to_hex(v) for v in w[:, 1]], f[:, 1],
            [to_hex(v) for v in w[:, 2]],
            [to_hex(v) for v in w[:, 3]],
            [to_hex(v) for v in w[:, 4]],
            f[:, 2],
        ]
        out = write_xlsx_mixed(out, V1_COLUMNS, cols, sheet_name="Parsed")
    else:
        res = decode_frames_v2_np(raw)
        w, f = res.windows, res.frames
        # serial_hex_to_excel_v2.py:84-115.
        cols = [
            f[:, 0], f[:, 1], f[:, 2], f[:, 3],
            [to_hex(v) for v in w[:, 1]],
            [to_hex(v) for v in w[:, 2]],
            [to_hex(v) for v in w[:, 3]],
            [to_hex(v) for v in w[:, 4]],
            [to_hex(v) for v in w[:, 5]],
        ]
        out = write_xlsx_mixed(out, V2_COLUMNS, cols, sheet_name="Parsed")
    print(f"有效组数={res.valid} 丢弃组数={res.discarded} 输出={out}")


def _add_correct(sub):
    p = sub.add_parser("correct", help="Parsed xlsx -> _filtered xlsx (stage 2)")
    p.add_argument("--input", type=Path, default=None)
    p.add_argument("--output", type=Path, default=None)
    p.add_argument("--in-place", action="store_true",
                   help="process_excel mode: rewrite the input with a "
                        "Corrected_BS_Beam column instead of filtering")
    p.add_argument("--run-tests", action="store_true",
                   help="run the embedded corrector self-tests and exit "
                        "(drop-in for bs_beam_correction.py --run-tests)")
    p.set_defaults(fn=_run_correct)


def _run_correct(args):
    if args.run_tests:
        from slam_process_tpu.ops.correct import self_test

        raise SystemExit(0 if self_test() else 1)
    if args.input is None:
        raise SystemExit("correct: --input is required (or --run-tests)")
    if args.input.suffix == ".txt":
        s = Session.from_log(args.input)
    else:
        s = Session.from_parsed_xlsx(args.input)
    s.correct()
    if args.in_place:
        out = args.output or args.input
        s.export_corrected(out)
        print(f"已写回修正文件: {out}")
        return
    out = args.output or args.input.with_name(args.input.stem + "_filtered.xlsx")
    s.export_filtered(out)
    print(f"已生成过滤后的修正文件: {out} 行数={len(s.filtered)}")


def _add_heatmap(sub):
    p = sub.add_parser("heatmap", help="render AoA x AoD mean-RSSI heatmap (stage 3a)")
    p.add_argument("--input", type=Path, required=True,
                   help="Parsed/filtered xlsx or raw .txt log")
    p.add_argument("--mapping", type=Path, required=True)
    p.add_argument("--output", type=Path, default=None)
    p.add_argument("--variant", choices=["v1", "v2", "v3"], default="v3",
                   help="v1=Parsed, v2=Parsed FLAG==1 only, v3=filtered input")
    p.add_argument("--colormap", default="viridis")
    p.add_argument("--no-logscale", action="store_true")
    p.add_argument("--vmin", type=float, default=None)
    p.add_argument("--vmax", type=float, default=None)
    p.add_argument("--blur-sigma", type=float, default=1.0)
    p.add_argument("--dpi", type=int, default=150)
    p.set_defaults(fn=_run_heatmap)


def _run_heatmap(args):
    scene_cfg = SceneConfig(
        keep_nan=True,
        fill_with_min=False,
        flag_filter=1 if args.variant == "v2" else None,
    )
    render_cfg = RenderConfig(
        colormap=args.colormap,
        use_log=not args.no_logscale,
        blur_sigma=args.blur_sigma,
        vmin=args.vmin,
        vmax=args.vmax,
        dpi=args.dpi,
    )
    if args.input.suffix == ".txt":
        s = Session.from_log(args.input)
        source = "filtered" if args.variant == "v3" else "parsed"
    elif args.variant == "v3":
        s = Session.from_filtered_xlsx(args.input)
        source = "filtered"
    else:
        s = Session.from_parsed_xlsx(args.input)
        source = "parsed"
    out = args.output
    if out is None:
        out = args.input.parent / "heatmap_outputs" / f"{args.input.stem}_heatmap.png"
    s.render_heatmap(args.mapping, out, scene_cfg, render_cfg, source=source,
                     title=f"BS-UE 波束对平均RSSI热力图 ({args.input.name})")
    print(f"输出PNG: {out}")


def _add_estimate(sub):
    p = sub.add_parser("estimate", help="multipath estimation + classified plot (stage 3b)")
    p.add_argument("--input", type=Path, required=True, help="filtered xlsx or raw .txt")
    p.add_argument("--mapping", type=Path, required=True)
    p.add_argument("--output", type=Path, default=None)
    p.add_argument("--model", default="nn_omp",
                   choices=["nn_omp", "nn_omp_v1", "nn_omp_v13", "nn_omp_v14",
                            "nn_omp_v15", "nn_omp_v16", "sm_sic", "svd",
                            "lasso_refine", "peak_picking", "fusion",
                            "omp_dense", "geometric"])
    p.add_argument("--max-paths", type=int, default=None)
    p.add_argument("--grid-res", type=float, default=None)
    p.add_argument("--beam-width", type=float, default=None)
    p.add_argument("--engine", choices=["host", "device"], default="host",
                   help="device = jitted accelerator estimator path")
    p.add_argument("--per-sweep", action="store_true",
                   help="time-resolved estimation: vmapped over every sweep "
                        "of the session (nn_omp/sm_sic; writes a table of "
                        "per-sweep paths instead of a figure)")
    p.add_argument("--tracks", action="store_true",
                   help="associate per-sweep paths into CLK-anchored tracks "
                        "with angular-velocity fits (implies --per-sweep; "
                        "writes a track table + trajectory figure)")
    p.add_argument("--gate-deg", type=float, default=10.0,
                   help="track association gate (Euclidean angle distance)")
    _add_change_args(p, gate="--tracks")
    p.set_defaults(fn=_run_estimate)


def _run_estimate(args):
    from slam_process_tpu.models import run_estimator  # late import: heavy

    if args.input.suffix == ".txt":
        s = Session.from_log(args.input)
        s.correct()
    else:
        s = Session.from_filtered_xlsx(args.input)
    overrides = {}
    if args.max_paths is not None:
        overrides["max_paths"] = args.max_paths
    if args.grid_res is not None:
        overrides["grid_res"] = args.grid_res
    if args.beam_width is not None:
        overrides["beam_width"] = args.beam_width
    if args.engine != "host":
        overrides["engine"] = args.engine
    if args.tracks:
        _run_estimate_tracks(args, s, overrides)
        return
    if args.changes:
        print("warning: --changes requires --tracks; no change events "
              "will be written", file=sys.stderr)
    if args.per_sweep:
        _run_estimate_per_sweep(args, s, overrides)
        return
    out = args.output or (args.input.parent / f"{s.name}_{args.model}.png")
    paths = run_estimator(args.model, s, args.mapping, out, **overrides)
    print(paths.to_string(index=False) if hasattr(paths, "to_string") else paths)
    print(f"输出PNG: {out}")


def _add_change_args(p, gate: str) -> None:
    """Scene-change-detection flags, shared by estimate/replay/watch
    (one definition so defaults and help stay in sync)."""
    p.add_argument("--changes", action="store_true",
                   help=f"with {gate}: detect scene change events (path "
                        "births/deaths, angular jumps, LoS handovers) and "
                        "write a CLK-stamped event table")
    p.add_argument("--min-persist", type=int, default=3,
                   help="observations before a track counts as a path "
                        "birth")
    p.add_argument("--min-gone", type=int, default=3,
                   help="consecutive missed sweeps before a confirmed "
                        "track counts as a path death")
    p.add_argument("--jump-deg", type=float, default=5.0,
                   help="angular displacement between consecutive "
                        "observations that counts as a jump event")


def _coerce_sweep_estimator(args, overrides, what: str) -> str:
    """Resolve --model/--engine for the per-sweep paths, warning loudly
    instead of silently coercing (only nn_omp/sm_sic estimate per sweep,
    and that path is device-only by design)."""
    if args.model in ("nn_omp", "sm_sic"):
        estimator = args.model
    else:
        estimator = "nn_omp"
        print(f"warning: --model {args.model} is not a sweep estimator "
              f"(nn_omp/sm_sic); using nn_omp for {what}", file=sys.stderr)
    if overrides.pop("engine", None) is not None:
        print(f"warning: --engine is ignored with {what} (per-sweep "
              "estimation always runs on device)", file=sys.stderr)
    return estimator


def _run_estimate_tracks(args, s, overrides):
    """CLK-anchored track association over per-sweep paths (ToA axis)."""
    import numpy as np

    from slam_process_tpu.io.xlsx import write_xlsx_table
    from slam_process_tpu.render.tracks import save_track_figure

    estimator = _coerce_sweep_estimator(args, overrides, "--tracks")
    tracks, times, vel = s.path_tracks(
        args.mapping, estimator=estimator, gate_deg=args.gate_deg,
        **overrides)
    rows = []
    for t in range(int(tracks.n_tracks)):
        for sweep in np.nonzero(tracks.observed[t])[0]:
            rows.append([t, sweep, times[sweep], tracks.pos_aoa[t][sweep],
                         tracks.pos_aod[t][sweep], tracks.power[t][sweep],
                         vel[0][t], vel[1][t]])
    table = np.asarray(rows, dtype=np.float64).reshape(-1, 8)
    base = args.output or (args.input.parent / f"{s.name}_tracks.xlsx")
    out = write_xlsx_table(
        base, ["Track", "Sweep", "CLK", "AoA", "AoD", "Power",
               "Vel_AoA_deg_per_tick", "Vel_AoD_deg_per_tick"], table)
    fig_path = Path(out).with_suffix(".png")
    save_track_figure(tracks, times, fig_path, velocities=vel,
                      title=f"Path tracks ({s.name})")
    n_fit = int(np.sum(vel[2][: int(tracks.n_tracks)]))
    print(f"tracks={int(tracks.n_tracks)} fitted={n_fit} "
          f"rows={len(rows)} 输出={out} 图={fig_path}")
    if args.changes:
        from slam_process_tpu.models.change_detection import (
            EVENT_KINDS,
            detect_scene_changes_np,
            scene_change_events,
        )

        changes = detect_scene_changes_np(
            tracks, min_persist=args.min_persist, min_gone=args.min_gone,
            jump_deg=args.jump_deg)
        events = scene_change_events(changes, tracks, times)
        ev_path = Path(out).with_name(Path(out).stem + "_changes.xlsx")
        write_xlsx_table(
            ev_path, ["Sweep", "CLK", "Kind", "Track", "AoA", "AoD",
                      "Power"], events)
        counts = {EVENT_KINDS[k]: int(np.sum(events[:, 2] == k))
                  for k in range(len(EVENT_KINDS))}
        print(f"changes={len(events)} {counts} 输出={ev_path}")


def _run_estimate_per_sweep(args, s, overrides):
    import numpy as np

    from slam_process_tpu.io.xlsx import write_xlsx_table

    estimator = _coerce_sweep_estimator(args, overrides, "--per-sweep")
    paths, sweep_valid = s.sweep_paths(args.mapping, estimator=estimator,
                                       **overrides)
    times = s.sweep_times(len(sweep_valid))
    power = paths.power if hasattr(paths, "power") else paths.metric
    rows = []
    for sweep in np.nonzero(sweep_valid)[0]:
        for k in np.nonzero(paths.valid[sweep])[0]:
            rows.append([sweep, times[sweep], k, paths.aoa[sweep][k],
                         paths.aod[sweep][k], power[sweep][k]])
    table = np.asarray(rows, dtype=np.float64).reshape(-1, 6)
    out = args.output or (args.input.parent / f"{s.name}_sweep_paths.xlsx")
    # write_xlsx_table may retry to <stem>_out.xlsx on PermissionError;
    # report the path it actually wrote.
    out = write_xlsx_table(out, ["Sweep", "CLK", "Path", "AoA", "AoD", "Power"],
                           table)
    print(f"sweeps={int(sweep_valid.sum())}/{len(sweep_valid)} "
          f"paths={len(rows)} 输出={out}")


def _add_session(sub):
    p = sub.add_parser("session", help="full end-to-end: log -> artifacts dir")
    p.add_argument("--log", type=Path, required=True)
    p.add_argument("--mapping", type=Path, required=True)
    p.add_argument("--outdir", type=Path, required=True)
    p.add_argument("--engine", choices=["host", "device"], default="host",
                   help="device = fused jitted accelerator pipeline")
    p.add_argument("--profile", type=Path, default=None,
                   help="capture a jax.profiler trace into this directory")
    p.set_defaults(fn=_run_session)


def _run_session(args):
    from slam_process_tpu.utils.profiling import trace

    with trace(args.profile):
        _run_session_inner(args)


def _run_session_inner(args):
    s = Session.from_log(args.log, engine=args.engine)
    s.correct()
    args.outdir.mkdir(parents=True, exist_ok=True)
    s.export_parsed(args.outdir / f"{s.name}.xlsx")
    s.export_filtered(args.outdir / f"{s.name}_filtered.xlsx")
    s.render_heatmap(args.mapping, args.outdir / f"{s.name}_heatmap.png")
    s.save_npz(args.outdir / f"{s.name}.npz")
    print(json.dumps({"session": s.name, "timings_s": s.timings,
                      "counters": {c.name: c.counts for c in s.counters}}))


def _pin_cpu_backend() -> None:
    """Keep a host-engine command off the accelerator.

    The ``--engine host`` contract is "no accelerator": its jitted helpers
    (the per-sweep estimator) must run on the CPU, and the process must
    not reserve the card's memory.  Restricting the platform list works
    only before JAX first initializes a backend; once one is up (a caller
    already used JAX in this process) this is a no-op and the host
    engine's explicit ``jax.default_device`` CPU scopes still apply.
    """
    import jax

    from slam_process_tpu.utils.cache import ensure_portable_cpu_isa

    ensure_portable_cpu_isa()
    jax.config.update("jax_platforms", "cpu")


def _add_replay(sub):
    p = sub.add_parser("replay", help="streaming replay: chunked real-time "
                                      "decode -> correct -> render")
    p.add_argument("--logs", type=Path, nargs="+", required=True)
    p.add_argument("--mapping", type=Path, required=True)
    p.add_argument("--outdir", type=Path, required=True)
    p.add_argument("--chunk-bytes", type=int, default=1 << 16)
    p.add_argument("--render-every", type=int, default=0,
                   help="re-render the live heatmap every N chunks")
    p.add_argument("--engine", choices=["host", "device"], default="host",
                   help="device = on-device streaming state machine")
    p.add_argument("--emit-capacity", type=int, default=None,
                   help="device emit-ring rows for --engine device "
                        "(default: sized to the log, so file replays can "
                        "never overflow the ring)")
    p.add_argument("--paths", action="store_true",
                   help="online per-sweep estimation + CLK tracks as "
                        "sweeps close (device: inside the jitted "
                        "streaming step; host: per closed sweep on the "
                        "CPU backend); writes <name>_stream_tracks.xlsx "
                        "per log")
    _add_change_args(p, gate="--paths")
    p.set_defaults(fn=_run_replay)


def _run_replay(args):
    import time

    import numpy as np

    from slam_process_tpu.io import read_hex_log
    from slam_process_tpu.io.angles import load_angle_lut
    from slam_process_tpu.io.schemas import write_filtered_table
    from slam_process_tpu.parallel.streaming import replay_log
    from slam_process_tpu.render.figures import save_heatmap_figure
    from slam_process_tpu.utils import extract_timestamp

    if args.engine == "host":
        _pin_cpu_backend()
    lut = load_angle_lut(args.mapping)
    args.outdir.mkdir(parents=True, exist_ok=True)
    if args.changes and not args.paths:
        # Same warn-loudly policy as _coerce_sweep_estimator: never
        # silently drop a requested output.
        print("warning: --changes requires --paths; no change events "
              "will be written", file=sys.stderr)
    stats = []
    for log in args.logs:
        name = extract_timestamp(str(log)) or log.stem
        raw = read_hex_log(log)
        t0 = time.perf_counter()
        if args.engine == "device":
            from slam_process_tpu.parallel.streaming_device import (
                replay_log_device,
            )

            # Ring sized to the log by default: kept rows can never
            # exceed the frame capacity, so file replays cannot hit the
            # emit-ring overflow error.
            ecap = args.emit_capacity or (len(raw) // 11 + 1)
            cp = None
            if args.paths:
                from slam_process_tpu.parallel.streaming_device import (
                    make_paths_spec,
                )

                cp = make_paths_spec(args.mapping)
            s = replay_log_device(raw, chunk_bytes=args.chunk_bytes,
                                  collect_filtered=True,
                                  emit_capacity=ecap,
                                  collect_paths=cp)
            s.block_until_ready()
        else:
            cp = None
            if args.paths:
                from slam_process_tpu.parallel.streaming_device import (
                    make_paths_spec,
                )

                cp = make_paths_spec(args.mapping)
            s = replay_log(raw, chunk_bytes=args.chunk_bytes,
                           render_every=args.render_every, angle_lut=lut,
                           collect_paths=cp)
        dt = time.perf_counter() - t0
        rendered = s.render(lut)
        save_heatmap_figure(
            rendered.blurred, rendered.aod_angles, rendered.aoa_angles,
            args.outdir / f"{name}_replay.png",
            title=f"streaming replay ({name})",
        )
        write_filtered_table(args.outdir / f"{name}_filtered.xlsx", s.filtered)
        if args.paths:
            _export_stream_tracks(s, name, args)
        stats.append({"session": name, "frames": s.n_frames,
                      "kept": s.n_kept, "sweeps": s.n_groups,
                      "frames_per_sec": round(s.n_frames / dt, 1)})
        print(json.dumps(stats[-1]))
    total = sum(x["frames"] for x in stats)
    print(json.dumps({"sessions": len(stats), "total_frames": total}))


def _seed_event_keys(events_path, with_session: bool) -> set:
    """Dedup keys from an existing JSONL feed (checkpoint resume).

    Malformed lines — including the torn tail a crash mid-write leaves —
    are skipped; a torn TAIL (no trailing newline) is additionally
    quarantined by appending a newline, so the first post-resume append
    starts on a fresh line instead of concatenating onto the fragment.
    """
    import json as _json

    from slam_process_tpu.models.change_detection import EVENT_KINDS

    seen: set = set()
    try:
        with open(events_path, "rb+") as f:
            data = f.read()
            if data and not data.endswith(b"\n"):
                f.write(b"\n")
    except OSError:
        return seen
    for line in data.decode("utf-8", "replace").splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            e = _json.loads(line)
            key = (int(e["sweep"]), EVENT_KINDS.index(e["kind"]),
                   int(e["track"]))
            seen.add(((e.get("session"),) + key) if with_session else key)
        except (ValueError, KeyError, TypeError):
            continue
    return seen


def _event_json_line(row, session=None) -> str:
    """One feed row (the [7] float64 detector row) as a JSONL line."""
    import json as _json

    from slam_process_tpu.models.change_detection import EVENT_KINDS

    d = {} if session is None else {"session": session}
    d.update({
        "sweep": int(row[0]), "clk": int(row[1]),
        "kind": EVENT_KINDS[int(row[2])], "track": int(row[3]),
        "aoa": round(float(row[4]), 4),
        "aod": round(float(row[5]), 4),
        "power": float(row[6]),
    })
    return _json.dumps(d)


def _make_event_emitter(args, session, seeded: bool = False):
    """LIVE scene-change feed for ``watch --events``: returns ``poll()``,
    which runs the INCREMENTAL change detector over the track columns of
    the sweeps that closed since the last poll and APPENDS their event
    rows to the JSONL file.

    Incremental is exact: the detectors are cumulative per-sweep
    predicates, and ``IncrementalChangeDetector`` fed one column at a
    time reproduces the batch table row-for-row (tests/
    test_change_detection.py) — while per-poll cost stays O(sweeps
    closed since last poll), not O(all history), so an unbounded live
    watch never slows down.  Track columns come from the session's
    in-stream tracker (``track_columns``): the device engine transfers
    only the new ring rows; the host engine advances its cached
    association state.

    ``seeded`` (checkpoint resume): the first poll replays the restored
    history through the detector to rebuild its state; the dedup set is
    pre-seeded from the existing feed file so the pre-crash rows are not
    appended twice (a torn tail line from the crash is skipped).
    """
    from slam_process_tpu.models.change_detection import (
        IncrementalChangeDetector,
    )
    from slam_process_tpu.utils.timestamps import ClkUnwrapper

    spec = session._paths_spec
    det = IncrementalChangeDetector(
        spec.max_tracks, min_persist=args.min_persist,
        min_gone=args.min_gone, jump_deg=args.jump_deg)
    unwrap = ClkUnwrapper()
    seen = _seed_event_keys(args.events, with_session=False) if seeded \
        else set()
    state = {"n": 0}

    def poll() -> int:
        n = session.n_sweeps_closed
        lo = state["n"]
        if n <= lo:
            return 0
        aoa, aod, power, obs, raw_times = session.track_columns(lo, n)
        state["n"] = n
        wrote = 0
        with open(args.events, "a") as f:
            for i in range(n - lo):
                t_u = unwrap.push(raw_times[i])
                for row in det.step(aoa[i], aod[i], power[i], obs[i],
                                    float(t_u)):
                    key = (int(row[0]), int(row[2]), int(row[3]))
                    if key in seen:
                        continue
                    seen.add(key)
                    f.write(_event_json_line(row) + "\n")
                    wrote += 1
        return wrote

    return poll


def _make_multi_event_emitter(args, session, names, seeded: bool = False):
    """Unified live scene-change feed for the multi-log watch: ONE JSONL
    file whose rows carry a ``session`` field naming the stream.

    Per-stream ``IncrementalChangeDetector`` + CLK-unwrap state; each
    poll reads the per-stream closed-sweep counts (one small device
    read) and then only the NEW track-ring rows of streams that
    advanced (``stream_track_columns``) — O(new sweeps) per poll, like
    the single-log emitter.  ``seeded`` (checkpoint resume) pre-loads
    the dedup set from the existing feed file so replayed history is
    not re-appended.
    """
    from slam_process_tpu.models.change_detection import (
        IncrementalChangeDetector,
    )
    from slam_process_tpu.utils.timestamps import ClkUnwrapper

    spec = session._paths_spec
    # MultihostMultiStream feeds its REAL local streams only (padding
    # slots are internal); everything else polls all streams.
    s_n = getattr(session, "n_local_real", session.n_streams)
    dets = [IncrementalChangeDetector(
        spec.max_tracks, min_persist=args.min_persist,
        min_gone=args.min_gone, jump_deg=args.jump_deg)
        for _ in range(s_n)]
    unwraps = [ClkUnwrapper() for _ in range(s_n)]
    seen = _seed_event_keys(args.events, with_session=True) if seeded \
        else set()
    lows = [0] * s_n

    def poll() -> int:
        ns = session.n_sweeps_closed_all()
        todo = [i for i in range(s_n) if int(ns[i]) > lows[i]]
        if not todo:
            return 0
        wrote = 0
        with open(args.events, "a") as f:
            for i in todo:
                hi = int(ns[i])
                aoa, aod, power, obs, raw = \
                    session.stream_track_columns(i, lows[i], hi)
                for j in range(hi - lows[i]):
                    t_u = unwraps[i].push(raw[j])
                    for row in dets[i].step(aoa[j], aod[j], power[j],
                                            obs[j], float(t_u)):
                        key = (names[i], int(row[0]), int(row[2]),
                               int(row[3]))
                        if key in seen:
                            continue
                        seen.add(key)
                        f.write(_event_json_line(row, session=names[i])
                                + "\n")
                        wrote += 1
                lows[i] = hi
        return wrote

    return poll


def _dedup_export_names(paths, prefix: str = "") -> list:
    """Per-stream export names from capture stems/timestamps,
    deduplicated — two captures named live.txt in different directories
    must not overwrite each other's outputs.  ``prefix`` namespaces a
    cluster process's exports (shared --outdir across hosts)."""
    from slam_process_tpu.utils import extract_timestamp

    names = [prefix + (extract_timestamp(str(p)) or p.stem)
             for p in paths]
    seen: dict = {}
    for i, nm in enumerate(names):
        if nm in seen:
            seen[nm] += 1
            names[i] = f"{nm}_{seen[nm]}"
        else:
            seen[nm] = 0
    return names


def _split_text_carry(buf: bytes):
    """Split a growing capture's buffer at the last whitespace:
    ``(tokenizable_prefix | None, carry)`` — the capture may have
    written half a token ("1A 2" of "1A 2B "), which must wait for more
    bytes.  The ONE definition behind every watch loop's incremental
    tokenization."""
    cut = max(buf.rfind(b" "), buf.rfind(b"\n"), buf.rfind(b"\r"),
              buf.rfind(b"\t"))
    if cut < 0:
        return None, buf
    return bytes(buf[: cut + 1]), buf[cut + 1:]


def _reconcile_paths_flag(args, s) -> bool:
    """Align --paths with what a restored checkpoint actually carries.

    The state decides (online estimation cannot be toggled mid-stream);
    the flag only selects exports — so never silently DROP accumulated
    tracks when the operator forgets --paths on the resume command, and
    never pretend to honor --paths the state cannot satisfy."""
    has = getattr(s, "_paths_spec", None) is not None
    if args.paths and not has:
        print("warning: --paths ignored — the restored checkpoint was "
              "created without online estimation", file=sys.stderr)
    elif has and not args.paths:
        print("note: the restored checkpoint carries online-estimation "
              "state; its tracks will be exported (pass --paths to "
              "silence this note)", file=sys.stderr)
    return has


def _export_stream_tracks(s, name: str, args) -> None:
    """Track + (optional) scene-change exports for a streaming session
    with ``collect_paths`` — shared by ``replay`` and ``watch``.

    The streamed tracks equal the offline tracks exactly (collect_paths
    parity), so the offline detector applies unchanged."""
    _export_tracks(*s.path_tracks(), name, args)


def _export_tracks(tracks, times, vel, name: str, args) -> None:
    import numpy as np

    from slam_process_tpu.io.xlsx import write_xlsx_table
    rows = []
    for t in range(int(tracks.n_tracks)):
        for sweep in np.nonzero(tracks.observed[t])[0]:
            rows.append([t, sweep, times[sweep],
                         tracks.pos_aoa[t][sweep],
                         tracks.pos_aod[t][sweep],
                         tracks.power[t][sweep],
                         vel[0][t], vel[1][t]])
    write_xlsx_table(
        args.outdir / f"{name}_stream_tracks.xlsx",
        ["Track", "Sweep", "CLK", "AoA", "AoD", "Power",
         "Vel_AoA_deg_per_tick", "Vel_AoD_deg_per_tick"],
        np.asarray(rows, dtype=np.float64).reshape(-1, 8))
    if args.changes:
        from slam_process_tpu.models.change_detection import (
            detect_scene_changes_np,
            scene_change_events,
        )

        ch = detect_scene_changes_np(
            tracks, min_persist=args.min_persist,
            min_gone=args.min_gone, jump_deg=args.jump_deg)
        ev = scene_change_events(ch, tracks, times)
        write_xlsx_table(
            args.outdir / f"{name}_stream_changes.xlsx",
            ["Sweep", "CLK", "Kind", "Track", "AoA", "AoD",
             "Power"], ev)
        print(f"changes={len(ev)} "
              f"输出={args.outdir / f'{name}_stream_changes.xlsx'}")


def _add_watch(sub):
    p = sub.add_parser(
        "watch",
        help="live-tail a GROWING serial log: new bytes are tokenized "
             "incrementally and fed to the streaming session as the "
             "capture writes them (the production counterpart of replay)")
    p.add_argument("--log", type=Path, default=None,
                   help="one growing capture file")
    p.add_argument("--logs", type=Path, nargs="+", default=None,
                   help="SEVERAL growing capture files, tailed as ONE "
                        "vmapped multi-stream device session (each file "
                        "finalizes independently on its own idle timeout; "
                        "--engine device only)")
    p.add_argument("--mapping", type=Path, required=True)
    p.add_argument("--outdir", type=Path, required=True)
    p.add_argument("--engine", choices=["host", "device"], default="host",
                   help="device = on-device streaming state machine")
    p.add_argument("--emit-capacity", type=int, default=None,
                   help="filtered-row ring capacity per stream (default: "
                        "auto-grow for --log; 262144 rows for --logs, "
                        "which cannot auto-grow)")
    p.add_argument("--poll-interval", type=float, default=0.5,
                   help="seconds between file-growth polls")
    p.add_argument("--idle-timeout", type=float, default=10.0,
                   help="stop after this many seconds without growth "
                        "(0 = watch until interrupted)")
    p.add_argument("--render-every", type=float, default=0.0,
                   help="re-render the live heatmap every N seconds "
                        "(0 = only at exit)")
    p.add_argument("--paths", action="store_true",
                   help="online per-sweep estimation + CLK tracks as "
                        "sweeps close (device: inside the jitted "
                        "streaming step; host: per closed sweep on the "
                        "CPU backend)")
    p.add_argument("--checkpoint", type=Path, default=None,
                   help="crash-recovery state file: restored at startup "
                        "when it exists; rewritten atomically every "
                        "--checkpoint-every seconds and at exit")
    p.add_argument("--checkpoint-every", type=float, default=0.0,
                   help="seconds between periodic checkpoints (0 = only "
                        "at exit; requires --checkpoint)")
    p.add_argument("--events", type=Path, default=None,
                   help="with --paths: append scene-change events (birth/"
                        "death/jump/LoS-handover) to this JSONL file LIVE "
                        "as the captures' sweeps close — the machine-"
                        "readable monitoring feed (in --logs mode rows "
                        "carry a 'session' field naming the stream; "
                        "--min-persist/--min-gone/--jump-deg set the "
                        "thresholds)")
    mh = p.add_argument_group(
        "multi-host", "run this watch as one process of a cluster: all "
        "processes' captures advance as ONE global streaming program "
        "(parallel/multihost.MultihostMultiStream); every process runs "
        "the same command with its own --logs and --process-id")
    mh.add_argument("--coordinator", type=str, default=None,
                    help="HOST:PORT of process 0 (enables multi-host "
                         "mode; requires --logs, --num-processes, "
                         "--process-id)")
    mh.add_argument("--num-processes", type=int, default=None)
    mh.add_argument("--process-id", type=int, default=None)
    mh.add_argument("--local-devices", type=int, default=None,
                    help="pin N virtual CPU devices + gloo collectives "
                         "(CPU clusters / tests); omit on accelerator "
                         "hosts, where each process drives card "
                         "--process-id")
    _add_change_args(p, gate="--paths")
    p.set_defaults(fn=_run_watch)


def _run_watch(args):
    import os
    import time

    import numpy as np

    if (args.log is None) == (args.logs is None):
        raise SystemExit("watch needs exactly one of --log / --logs")
    # Shared flag validation BEFORE the multi-host dispatch: these
    # errors must fire identically in cluster mode (an invalid
    # --emit-capacity would otherwise surface as an obscure compile
    # error after the cluster already rendezvoused).
    if args.checkpoint_every and not args.checkpoint:
        raise SystemExit("--checkpoint-every requires --checkpoint "
                         "(no state file to write to)")
    if args.emit_capacity is not None and args.emit_capacity <= 0:
        raise SystemExit("--emit-capacity must be a positive row count")
    if args.coordinator is not None:
        return _run_watch_multihost(args)
    if args.num_processes is not None or args.process_id is not None:
        raise SystemExit("--num-processes/--process-id require "
                         "--coordinator (multi-host watch mode)")
    if args.logs is not None:
        if len(args.logs) == 1:
            args.log = args.logs[0]
        else:
            return _run_watch_multi(args)
    if args.events is not None and not args.paths and not (
            args.checkpoint and args.checkpoint.exists()):
        # With a restorable checkpoint the STATE decides whether online
        # estimation exists (_reconcile_paths_flag) — the resume command
        # must not need a different flag set than the one that crashed.
        raise SystemExit("--events requires --paths (the events derive "
                         "from the online tracks)")
    if args.engine == "host":
        _pin_cpu_backend()

    from slam_process_tpu.io.angles import load_angle_lut
    from slam_process_tpu.io.hexlog import tokenize_hex
    from slam_process_tpu.io.schemas import write_filtered_table
    from slam_process_tpu.render.figures import save_heatmap_figure
    from slam_process_tpu.utils import extract_timestamp

    lut = load_angle_lut(args.mapping)
    args.outdir.mkdir(parents=True, exist_ok=True)
    name = extract_timestamp(str(args.log)) or args.log.stem
    if args.changes and not args.paths:
        print("warning: --changes requires --paths; no change events "
              "will be written", file=sys.stderr)
    pos = 0
    text_carry = b""
    from slam_process_tpu.parallel.streaming_device import make_paths_spec

    if args.engine == "device":
        from slam_process_tpu.parallel.streaming_device import (
            DeviceStreamingSession as Sess,
        )
    else:
        from slam_process_tpu.parallel.streaming import (
            StreamingSession as Sess,
        )
    was_restored = False
    if args.checkpoint and args.checkpoint.exists():
        # Crash recovery: the checkpoint holds the session state AND this
        # loop's cursor (file offset + tokenizer text carry), so the
        # watch resumes exactly where the dead process stopped.  A
        # device-engine checkpoint restores only with --engine device and
        # vice versa (the restore raises a kind-mismatch error).
        s = Sess.restore(args.checkpoint)
        was_restored = True
        resume_completed = s._finalized
        if resume_completed:
            # A crash AFTER finalize (e.g. during export) must not strand
            # the capture's only surviving state: skip straight to the
            # export stage and re-write the outputs from the checkpoint.
            print(f"{args.checkpoint} is from a COMPLETED watch; "
                  "re-exporting its results", file=sys.stderr)
        args.paths = _reconcile_paths_flag(args, s)
        if args.engine == "device" and not s.collect_filtered:
            raise SystemExit(
                f"{args.checkpoint} was created without collect_filtered; "
                "watch needs the emit ring to export the filtered table")
        if (args.emit_capacity is not None and args.engine == "device"
                and s._ecap != args.emit_capacity):
            print(f"warning: --emit-capacity {args.emit_capacity} ignored "
                  f"— the checkpoint's ring capacity ({s._ecap}) wins on "
                  "resume", file=sys.stderr)
        host = s.checkpoint_extra or {}
        pos = int(host.get("pos", 0))
        text_carry = bytes(host.get("text_carry", b""))
        print(f"resumed from {args.checkpoint} at byte {pos}",
              file=sys.stderr)
    elif args.engine == "device":
        # Unknown final size: the emit ring auto-grows from the
        # conservative host-side bound as bytes arrive (unless pinned
        # with --emit-capacity).
        cp = make_paths_spec(args.mapping) if args.paths else None
        s = Sess(collect_filtered=True, collect_paths=cp,
                 emit_capacity=args.emit_capacity)
        resume_completed = False
    else:
        cp = make_paths_spec(args.mapping) if args.paths else None
        s = Sess(collect_paths=cp)
        resume_completed = False

    emitter = None
    events_written = 0
    if args.events is not None and args.paths:
        args.events.parent.mkdir(parents=True, exist_ok=True)
        emitter = _make_event_emitter(args, s, seeded=was_restored)
    elif args.events is not None:
        # Only reachable when a restored checkpoint lacked online
        # estimation and _reconcile_paths_flag cleared --paths.
        print("warning: --events ignored — the restored checkpoint was "
              "created without online estimation", file=sys.stderr)

    def save_ckpt():
        if args.checkpoint:
            s.save_checkpoint(args.checkpoint,
                              extra={"pos": pos, "text_carry": text_carry})

    def tail_png():
        rendered = s.render(lut)
        out = args.outdir / f"{name}_watch.png"
        save_heatmap_figure(
            rendered.blurred, rendered.aod_angles, rendered.aoa_angles,
            out, title=f"live watch ({name})")
        return out

    last_growth = time.monotonic()
    last_render = time.monotonic()
    last_ckpt = time.monotonic()
    fed_tokens = 0
    try:
        while not resume_completed:
            try:
                size = os.path.getsize(args.log)
            except OSError:
                size = pos
            now = time.monotonic()
            if size > pos:
                try:
                    with open(args.log, "rb") as f:
                        f.seek(pos)
                        data = f.read(size - pos)
                except OSError:
                    # Log rotated/deleted between the size poll and the
                    # read: treat as no growth; the accumulated state
                    # still finalizes and exports on idle timeout.
                    time.sleep(args.poll_interval)
                    continue
                pos = size
                prefix, text_carry = _split_text_carry(text_carry + data)
                if prefix is not None:
                    tokens = tokenize_hex(prefix)
                    if len(tokens):
                        s.feed(tokens)
                        fed_tokens += len(tokens)
                        if emitter:
                            events_written += emitter()
                last_growth = now
            elif args.idle_timeout and now - last_growth > args.idle_timeout:
                break
            if args.render_every and now - last_render >= args.render_every:
                tail_png()
                last_render = now
            if (args.checkpoint and args.checkpoint_every
                    and now - last_ckpt >= args.checkpoint_every):
                save_ckpt()
                last_ckpt = now
            time.sleep(args.poll_interval)
    except KeyboardInterrupt:
        pass
    if not resume_completed:
        tokens = tokenize_hex(bytes(text_carry))
        if len(tokens):
            s.feed(tokens)
            fed_tokens += len(tokens)
            text_carry = b""
        s.finalize()
        save_ckpt()
    if emitter:
        events_written += emitter()   # the flush-closed final sweep
    png = tail_png()
    write_filtered_table(args.outdir / f"{name}_filtered.xlsx", s.filtered)
    if args.paths:
        _export_stream_tracks(s, name, args)
    summary = {"session": name, "bytes_seen": pos,
               "tokens": fed_tokens, "frames": int(s.n_frames),
               "kept": int(s.n_kept), "sweeps": int(s.n_groups),
               "png": str(png)}
    if emitter:
        summary["events"] = events_written
    print(json.dumps(summary))


def _run_watch_multihost(args):
    """One process of a MULTI-HOST watch cluster: every process tails its
    own ``--logs`` and all captures advance as ONE global streaming
    program (``parallel/multihost.MultihostMultiStream``).

    Launch the same command on every host with its own ``--logs`` /
    ``--process-id`` (and a shared ``--coordinator``).  The collective
    protocol per poll tick is identical on every process — (1) allgather
    the local (wants-finalize, all-done) bits, (2) feed this round's
    local chunks (window rounds are allgather-agreed inside ``feed``),
    (3) if ANY process wants a finalize, one collective masked flush
    runs (empty mask on the others), (4) exit when every process reports
    all its streams done — so the sequence of collective dispatches can
    never diverge.  The allgather doubles as a tick barrier, keeping the
    processes in lockstep regardless of poll-loop drift.

    Ctrl-C should go to the WHOLE cluster (each process treats it as
    "drain and finalize my streams at the next tick" and keeps
    participating in the collectives until the others finish, so a
    single-host interrupt degrades to a clean early finalize of that
    host's captures rather than a hang).
    """
    import os
    import time

    import numpy as np

    if args.logs is None:
        raise SystemExit("--coordinator requires --logs (each process "
                         "tails its own capture set)")
    if args.num_processes is None or args.process_id is None:
        raise SystemExit("--coordinator requires --num-processes and "
                         "--process-id")
    if args.engine != "device":
        raise SystemExit("multi-host watch requires --engine device")
    if args.checkpoint:
        raise SystemExit(
            "--checkpoint is not supported in multi-host watch mode "
            "(run per-host watches without --coordinator for it)")
    if args.events is not None and not args.paths:
        raise SystemExit("--events requires --paths (the events derive "
                         "from the online tracks)")
    if args.changes and not args.paths:
        print("warning: --changes requires --paths; no change events "
              "will be written", file=sys.stderr)

    # Process-group init MUST precede the first backend touch.
    from slam_process_tpu.parallel.multihost import (
        MultihostMultiStream,
        global_data_mesh,
        initialize_multihost,
    )

    initialize_multihost(coordinator_address=args.coordinator,
                         num_processes=args.num_processes,
                         process_id=args.process_id,
                         local_device_count=args.local_devices)

    from jax.experimental import multihost_utils

    from slam_process_tpu.io.angles import load_angle_lut
    from slam_process_tpu.io.hexlog import tokenize_hex
    from slam_process_tpu.io.schemas import write_filtered_table
    from slam_process_tpu.ops.scene import grid_from_sums_np
    from slam_process_tpu.parallel.streaming_device import make_paths_spec
    from slam_process_tpu.render.figures import save_heatmap_figure
    from slam_process_tpu.render.heatmap import render_intensity
    from slam_process_tpu.utils import extract_timestamp

    logs = list(args.logs)
    n = len(logs)
    # p<id>_ prefix: hosts may share an --outdir (network filesystem);
    # same-stem captures on different hosts must not overwrite each
    # other's exports.
    names = _dedup_export_names(logs, prefix=f"p{args.process_id}_")
    lut = load_angle_lut(args.mapping)
    args.outdir.mkdir(parents=True, exist_ok=True)
    ecap = args.emit_capacity if args.emit_capacity else 1 << 18
    cp = make_paths_spec(args.mapping) if args.paths else None
    mesh = global_data_mesh(model=1)
    s = MultihostMultiStream(mesh, n, collect_paths=cp,
                             emit_capacity=ecap)
    emitter = None
    events_written = 0
    if args.events is not None and args.paths:
        # Per-process local feed: the readers behind it are
        # addressable-shard slices (no collective dispatch), so polling
        # never perturbs the cluster's lockstep.
        args.events.parent.mkdir(parents=True, exist_ok=True)
        emitter = _make_multi_event_emitter(args, s, names)
    print(f"multi-host watch: process {args.process_id}/"
          f"{args.num_processes}, {n} local stream(s), "
          f"{s.n_streams_real} global ({s.n_streams} padded) over a "
          f"{tuple(mesh.shape.values())} mesh", file=sys.stderr)

    def render_local():
        from slam_process_tpu.config import RenderConfig, SceneConfig

        _nf, _nk, _ng, sums, counts, _ovf = s.local_results()
        pngs = []
        for i in range(n):
            grid = grid_from_sums_np(sums[i].astype(np.float64),
                                     counts[i].astype(np.int64))
            rendered = render_intensity(
                grid, lut, SceneConfig(keep_nan=True, fill_with_min=False),
                RenderConfig())
            png = args.outdir / f"{names[i]}_watch.png"
            save_heatmap_figure(rendered.blurred, rendered.aod_angles,
                                rendered.aoa_angles, png,
                                title=f"live watch ({names[i]})")
            pngs.append(png)
        return pngs

    pos = [0] * n
    carry = [b""] * n
    done = np.zeros(n, bool)
    now0 = time.monotonic()
    last_growth = [now0] * n
    last_render = now0
    force = False
    while True:
        now = time.monotonic()
        chunks = [b""] * n
        to_finalize = []
        for i in range(n):
            if done[i]:
                continue
            try:
                size = os.path.getsize(logs[i])
            except OSError:
                size = pos[i]
            if size > pos[i] and not force:
                try:
                    with open(logs[i], "rb") as f:
                        f.seek(pos[i])
                        data = f.read(size - pos[i])
                except OSError:
                    continue
                pos[i] = size
                prefix, carry[i] = _split_text_carry(carry[i] + data)
                if prefix is not None:
                    chunks[i] = tokenize_hex(prefix)
                last_growth[i] = now
            elif force or (args.idle_timeout
                           and now - last_growth[i]
                           > args.idle_timeout):
                chunks[i] = tokenize_hex(bytes(carry[i]))
                carry[i] = b""
                to_finalize.append(i)
        will_all_be_done = bool(done.all()) or (
            len(to_finalize) + int(done.sum()) == n)
        # The tick's ONE coordination point: who needs a flush, who
        # is finished.  Every later branch keys off this shared
        # result, so the collective sequence is identical everywhere.
        sync = multihost_utils.process_allgather(np.asarray(
            [int(bool(to_finalize)), int(will_all_be_done)],
            np.int32))
        sync = np.asarray(sync).reshape(-1, 2)
        s.feed(chunks)
        if bool(sync[:, 0].any()):
            s.finalize_streams(to_finalize)
            if to_finalize:
                done[to_finalize] = True
                print(f"stream(s) {to_finalize} finalized "
                      f"({(~done).sum()} still live)",
                      file=sys.stderr)
        if emitter:
            events_written += emitter()
        if bool(sync[:, 1].all()):
            break
        if (args.render_every
                and now - last_render >= args.render_every):
            render_local()
            last_render = now
        try:
            # Ctrl-C is handled ONLY here, where the process is idle: an
            # interrupt inside the collective sequence above would abort
            # a tick partway and desync the cluster (peers would wait in
            # a mismatched collective).  The sleep is where a watch
            # spends almost all its wall time, so a cluster-wide SIGINT
            # lands here in practice; the next tick then drains and
            # finalizes this host's streams while it keeps participating
            # until every host finishes.
            time.sleep(args.poll_interval)
        except KeyboardInterrupt:
            force = True

    try:
        s.finalize()   # no-op (everything flushed); keeps state closed
        if emitter:
            events_written += emitter()   # finalize-closed final sweeps
        nf, nk, ng, _sums, _counts, _ovf = s.local_results()
        pngs = render_local()
        stats = []
        for i in range(n):
            write_filtered_table(
                args.outdir / f"{names[i]}_filtered.xlsx",
                s.local_stream_filtered(i))
            if args.paths:
                _export_tracks(*s.local_stream_tracks(i), names[i], args)
            stats.append({"session": names[i],
                          "process": args.process_id,
                          "bytes_seen": pos[i], "frames": int(nf[i]),
                          "kept": int(nk[i]), "sweeps": int(ng[i]),
                          "png": str(pngs[i])})
            print(json.dumps(stats[-1]))
        totals = {"process": args.process_id, "local_streams": n,
                  "global_streams": s.n_streams_real,
                  "total_frames": int(sum(x["frames"] for x in stats))}
        if emitter:
            totals["events"] = events_written
        print(json.dumps(totals))
    finally:
        # ALWAYS reached — even when a local export fails (e.g. an
        # emit-ring overflow), so healthy peers are not stranded.  Holds
        # the cluster together until every process finished its local
        # exports: per-host export time varies by minutes on CPU, and a
        # process that exits early trips the distributed runtime's
        # shutdown barrier timeout on the laggards (observed: the whole
        # cluster terminated with BarrierError after one host's exports
        # outlasted the shutdown window).
        multihost_utils.sync_global_devices("multihost-watch-exit")


def _run_watch_multi(args):
    """Tail S growing capture files as ONE vmapped multi-stream device
    session.  Each file keeps its own cursor/tokenizer carry and its own
    idle timeout: a capture that stops writing is finalized ALONE
    (``finalize_streams`` — its last sweep closes and its final online-
    estimation step runs) while the other feeds keep advancing.  Exports
    (png, filtered xlsx, optional tracks/changes) are written per stream
    at exit; --checkpoint covers the whole multi-stream state plus every
    cursor."""
    import os
    import time

    import numpy as np

    from slam_process_tpu.io.angles import load_angle_lut
    from slam_process_tpu.io.hexlog import tokenize_hex
    from slam_process_tpu.io.schemas import write_filtered_table
    from slam_process_tpu.ops.scene import grid_from_sums_np
    from slam_process_tpu.parallel.streaming_device import (
        MultiStreamingSession,
        make_paths_spec,
    )
    from slam_process_tpu.render.figures import save_heatmap_figure
    from slam_process_tpu.render.heatmap import render_intensity
    from slam_process_tpu.utils import extract_timestamp

    if args.engine != "device":
        raise SystemExit("watch with multiple --logs requires "
                         "--engine device (one vmapped session)")
    if args.changes and not args.paths:
        print("warning: --changes requires --paths; no change events "
              "will be written", file=sys.stderr)
    if args.events is not None and not args.paths and not (
            args.checkpoint and args.checkpoint.exists()):
        # Same deferral as the single-log watch: a restorable checkpoint's
        # state decides whether online estimation exists.
        raise SystemExit("--events requires --paths (the events derive "
                         "from the online tracks)")
    logs = list(args.logs)
    n = len(logs)
    names = _dedup_export_names(logs)
    lut = load_angle_lut(args.mapping)
    args.outdir.mkdir(parents=True, exist_ok=True)
    ecap = args.emit_capacity if args.emit_capacity else 1 << 18

    pos = [0] * n
    carry = [b""] * n
    was_restored = False
    if args.checkpoint and args.checkpoint.exists():
        s = MultiStreamingSession.restore(args.checkpoint)
        was_restored = True
        if s.n_streams != n:
            raise SystemExit(
                f"{args.checkpoint} holds {s.n_streams} streams, "
                f"--logs names {n}")
        args.paths = _reconcile_paths_flag(args, s)
        if (args.emit_capacity is not None
                and s._ecap != args.emit_capacity):
            print(f"warning: --emit-capacity {args.emit_capacity} ignored "
                  f"— the checkpoint's ring capacity ({s._ecap}) wins on "
                  "resume", file=sys.stderr)
        host = s.checkpoint_extra or {}
        pos = [int(x) for x in host.get("pos", pos)]
        carry = [bytes(x) for x in host.get("text_carry", carry)]
        print(f"resumed from {args.checkpoint}: cursors {pos}, "
              f"{int(np.sum(s._stream_finalized))} stream(s) already "
              "finalized", file=sys.stderr)
    else:
        cp = make_paths_spec(args.mapping) if args.paths else None
        s = MultiStreamingSession(n, collect_paths=cp, emit_capacity=ecap)

    emitter = None
    events_written = 0
    if args.events is not None and args.paths:
        args.events.parent.mkdir(parents=True, exist_ok=True)
        emitter = _make_multi_event_emitter(args, s, names,
                                            seeded=was_restored)
    elif args.events is not None:
        print("warning: --events ignored — the restored checkpoint was "
              "created without online estimation", file=sys.stderr)

    def save_ckpt():
        if args.checkpoint:
            s.save_checkpoint(args.checkpoint,
                              extra={"pos": list(pos),
                                     "text_carry": list(carry)})

    def render_all():
        from slam_process_tpu.config import RenderConfig, SceneConfig

        _nf, _nk, _ng, sums, counts, _ovf = s.results()
        pngs = []
        for i in range(n):
            grid = grid_from_sums_np(sums[i].astype(np.float64),
                                     counts[i].astype(np.int64))
            rendered = render_intensity(
                grid, lut, SceneConfig(keep_nan=True, fill_with_min=False),
                RenderConfig())
            png = args.outdir / f"{names[i]}_watch.png"
            save_heatmap_figure(rendered.blurred, rendered.aod_angles,
                                rendered.aoa_angles, png,
                                title=f"live watch ({names[i]})")
            pngs.append(png)
        return pngs

    done = np.asarray(s._stream_finalized).copy()
    now0 = time.monotonic()
    last_growth = [now0] * n
    last_render = now0
    last_ckpt = now0
    try:
        while not done.all():
            now = time.monotonic()
            chunks = [b""] * n
            to_finalize = []
            for i in range(n):
                if done[i]:
                    continue
                try:
                    size = os.path.getsize(logs[i])
                except OSError:
                    size = pos[i]
                if size > pos[i]:
                    try:
                        with open(logs[i], "rb") as f:
                            f.seek(pos[i])
                            data = f.read(size - pos[i])
                    except OSError:
                        continue
                    pos[i] = size
                    prefix, carry[i] = _split_text_carry(carry[i] + data)
                    if prefix is not None:
                        chunks[i] = tokenize_hex(prefix)
                    last_growth[i] = now
                elif (args.idle_timeout
                      and now - last_growth[i] > args.idle_timeout):
                    # This capture stopped: feed its tokenizer tail in
                    # this round, then close it ALONE.
                    chunks[i] = tokenize_hex(bytes(carry[i]))
                    carry[i] = b""
                    to_finalize.append(i)
            fed_round = False
            if any(len(c) for c in chunks):
                s.feed(chunks)
                fed_round = True
            if to_finalize:
                s.finalize_streams(to_finalize)
                done[to_finalize] = True
                fed_round = True
                print(f"stream(s) {to_finalize} finalized "
                      f"({(~done).sum()} still live)", file=sys.stderr)
            if emitter and fed_round:
                events_written += emitter()
            if (args.render_every
                    and now - last_render >= args.render_every):
                render_all()
                last_render = now
            if (args.checkpoint and args.checkpoint_every
                    and now - last_ckpt >= args.checkpoint_every):
                save_ckpt()
                last_ckpt = now
            time.sleep(args.poll_interval)
    except KeyboardInterrupt:
        pass
    # Interrupt / exit: flush whatever is still open (tails included).
    if not done.all():
        tails = [tokenize_hex(bytes(carry[i])) if not done[i] else b""
                 for i in range(n)]
        carry = [b""] * n
        if any(len(t) for t in tails):
            s.feed(tails)
        s.finalize()
    save_ckpt()
    if emitter:
        events_written += emitter()   # the finalize-closed final sweeps

    nf, nk, ng, _sums, _counts, _ovf = s.results()
    pngs = render_all()
    stats = []
    for i in range(n):
        png = pngs[i]
        write_filtered_table(args.outdir / f"{names[i]}_filtered.xlsx",
                             s.stream_filtered(i))
        if args.paths:
            _export_tracks(*s.stream_tracks(i), names[i], args)
        stats.append({"session": names[i], "bytes_seen": pos[i],
                      "frames": int(nf[i]), "kept": int(nk[i]),
                      "sweeps": int(ng[i]), "png": str(png)})
        print(json.dumps(stats[-1]))
    totals = {"streams": n,
              "total_frames": int(sum(x["frames"] for x in stats))}
    if emitter:
        totals["events"] = events_written
    print(json.dumps(totals))


def _add_run_config(sub):
    p = sub.add_parser("run-config",
                       help="run one of the five named benchmark configs")
    p.add_argument("name", choices=["serial_hex_to_excel_v3",
                                    "excel_heatmap_v3", "bs_beam_correction",
                                    "batched_session", "streaming_replay"])
    p.add_argument("--data-dir", type=Path, default=None)
    p.add_argument("--mapping", type=Path, default=None)
    p.add_argument("--outdir", type=Path, default=None)
    p.set_defaults(fn=_run_named_config)


def _run_named_config(args):
    from slam_process_tpu.pipeline.configs import run_named_config

    result = run_named_config(args.name, args.data_dir, args.mapping,
                              args.outdir)
    print(json.dumps(result, default=str))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="slam_process_tpu",
                                     description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_decode(sub)
    _add_correct(sub)
    _add_heatmap(sub)
    _add_estimate(sub)
    _add_session(sub)
    _add_replay(sub)
    _add_watch(sub)
    _add_run_config(sub)
    args = parser.parse_args(argv)
    logger = get_logger()
    try:
        args.fn(args)
    except (OSError, ValueError, KeyError, IndexError, zipfile.BadZipFile) as e:
        logger.error("处理失败: %s", e)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
