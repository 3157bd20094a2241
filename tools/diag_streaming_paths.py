"""Streaming with online estimation: tracker engine A/B, and the step's time.

Replays one capture (default: the generated archive's largest, 100,280
frames over 58 sweeps) through ``DeviceStreamingSession`` with
``collect_paths`` in 1 MiB chunks, end to end (host feed loop included,
closed by ``block_until_ready``), and

1. times the two tracker engines in turns — while_loop, Triton kernel,
   kernel, loop — ``--reps`` replays each after a warm-up replay, and
   checks that both give identical paths and tracks;
2. traces one replay with each engine and sums device time per
   named scope (``sweep_sums``, ``sweep_estimator``, ``tracker``), per
   XLA module and per op (``utils/device_timing.py``), with the device's
   busy time (union of event intervals) over its span.

Run on the card:  python tools/diag_streaming_paths.py [--reps 5]
Writes the JSON summary to chiprun_out/diag_streaming_paths.json too.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

SCOPES = ("sweep_sums", "sweep_estimator", "tracker")


def _set_tracker_engine(kernel: bool) -> None:
    from slam_process_tpu.parallel import streaming_device as sd

    sd._use_tracker_kernel = lambda: kernel
    for f in (sd._build_step, sd._build_flush, sd._build_multi_step,
              sd._build_multi_flush):
        f.cache_clear()


def _replay(raw, spec, chunk):
    from slam_process_tpu.parallel.streaming_device import (
        DeviceStreamingSession,
    )

    s = DeviceStreamingSession(chunk_bytes=chunk, collect_paths=spec)
    for off in range(0, len(raw), chunk):
        s.feed(raw[off:off + chunk])
    s.finalize()
    s.block_until_ready()
    return s


def _fingerprint(s):
    paths, valid = s.sweep_paths()
    tracks, times, _ = s.path_tracks()
    return [np.asarray(x) for x in (valid, paths.aoa_idx, paths.aod_idx,
                                    tracks.pos_aoa, tracks.pos_aod,
                                    tracks.power, tracks.observed, times)]


def main() -> None:
    import jax

    from slam_process_tpu.io import synth
    from slam_process_tpu.io.angles import write_angle_map
    from slam_process_tpu.parallel import streaming_device as sd
    from slam_process_tpu.utils.device_timing import (
        device_busy,
        module_device_times,
        op_device_times,
        scope_device_times,
    )

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100_280)
    ap.add_argument("--sweeps", type=int, default=58)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--chunk", type=int, default=1 << 20)
    args = ap.parse_args()

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
    except OSError:
        smi = "no nvidia-smi"
    work = REPO / "build" / "diag"
    work.mkdir(parents=True, exist_ok=True)
    raw = synth.capture(18, args.frames, args.sweeps).wire
    spec = sd.make_paths_spec(write_angle_map(work / "beam_angle.xlsx"))
    default_kernel = sd._use_tracker_kernel()
    summary = {"card": smi, "device": str(jax.devices()[0]),
               "frames": args.frames, "sweeps": args.sweeps,
               "chunk": args.chunk, "default_tracker_kernel": default_kernel,
               "turns": []}

    ref = None
    for kernel in (False, True, True, False):
        _set_tracker_engine(kernel)
        t = time.perf_counter()
        s = _replay(raw, spec, args.chunk)          # compiles
        warm = time.perf_counter() - t
        fp = _fingerprint(s)
        if ref is None:
            ref = fp
        for a, b in zip(fp, ref):
            if not np.array_equal(a, b, equal_nan=True):
                raise AssertionError("tracker engines disagree")
        runs = []
        for _ in range(args.reps):
            t = time.perf_counter()
            _replay(raw, spec, args.chunk)
            runs.append(time.perf_counter() - t)
        turn = {"engine": "kernel" if kernel else "loop",
                "first_replay_s": warm, "median_s": statistics.median(runs),
                "runs_s": runs}
        summary["turns"].append(turn)
        print(json.dumps(turn), flush=True)
    for eng in ("loop", "kernel"):
        summary[f"{eng}_median_of_medians_s"] = statistics.median(
            t["median_s"] for t in summary["turns"] if t["engine"] == eng)

    for kernel in (False, True):
        eng = "kernel" if kernel else "loop"
        _set_tracker_engine(kernel)
        _replay(raw, spec, args.chunk)
        with tempfile.TemporaryDirectory(dir=work) as d:
            t = time.perf_counter()
            with jax.profiler.trace(d):
                _replay(raw, spec, args.chunk)
            busy, span = device_busy(d)
            ops = op_device_times(d)
            summary[f"trace_{eng}"] = {
                "window_wall_s": time.perf_counter() - t,
                "device_busy_s": busy, "device_span_s": span,
                "scope_device_s": scope_device_times(d, SCOPES),
                "module_device_s": {k: sum(v) for k, v in
                                    module_device_times(d).items()},
                "top_ops_device_s": dict(sorted(
                    ops.items(), key=lambda kv: -kv[1])[:12]),
            }
    _set_tracker_engine(default_kernel)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "diag_streaming_paths.json").write_text(
        json.dumps(summary, indent=1, default=str))
    print(json.dumps({k: v for k, v in summary.items() if k != "turns"},
                     default=str), flush=True)


if __name__ == "__main__":
    main()
