"""The five BASELINE.json benchmark configs as named, runnable pipelines.

    1. serial_hex_to_excel_v3 — one log -> Parsed table + intensity matrix
    2. excel_heatmap_v3      — one filtered scan -> static heatmap PNG
    3. bs_beam_correction    — correction + corrected estimation render
    4. batched_session       — every capture through the device pipeline
    5. streaming_replay      — chunked real-time decode->correct->render

Each entry returns a JSON-serializable result dict.  Driven by
``python -m slam_process_tpu.pipeline.cli run-config <name> ...``.
"""

from __future__ import annotations

import glob
import time
from pathlib import Path
from typing import Callable, Dict, Optional

from slam_process_tpu.pipeline.session import Session


def _default_logs(data_dir: Path):
    logs = sorted(glob.glob(str(data_dir / "*.txt")))
    if not logs:
        raise FileNotFoundError(f"no .txt logs under {data_dir}")
    return logs


def config_decode(data_dir: Path, mapping: Path, outdir: Path) -> dict:
    log = _default_logs(data_dir)[0]
    s = Session.from_log(log)
    s.export_parsed(outdir / f"{s.name}.xlsx")
    grid = s.intensity(source="parsed")
    return {"config": "serial_hex_to_excel_v3", "log": str(log),
            "frames": int(len(s.frames)),
            "observed_cells": int((grid.counts > 0).sum()),
            "timings_s": s.timings}


def config_heatmap(data_dir: Path, mapping: Path, outdir: Path) -> dict:
    filtered = sorted(glob.glob(str(data_dir / "*_filtered.xlsx")))[0]
    s = Session.from_filtered_xlsx(filtered)
    s.render_heatmap(mapping, outdir / f"{s.name}_heatmap.png")
    return {"config": "excel_heatmap_v3", "input": str(filtered),
            "png": str(outdir / f"{s.name}_heatmap.png"),
            "timings_s": s.timings}


def config_correction(data_dir: Path, mapping: Path, outdir: Path) -> dict:
    from slam_process_tpu.models import run_estimator

    log = _default_logs(data_dir)[0]
    s = Session.from_log(log)
    s.correct()
    s.export_filtered(outdir / f"{s.name}_filtered.xlsx")
    paths = run_estimator("nn_omp", s, mapping,
                          outdir / f"{s.name}_corrected_render.png")
    return {"config": "bs_beam_correction", "log": str(log),
            "corrected_rows": int(len(s.filtered)),
            "paths": paths.to_dict("records"), "timings_s": s.timings}


def config_batched(data_dir: Path, mapping: Path, outdir: Path) -> dict:
    import jax

    from slam_process_tpu.io import read_hex_log
    from slam_process_tpu.pipeline.device import run_session_on_device

    logs = _default_logs(data_dir)
    raw = [read_hex_log(p) for p in logs]
    warm = [run_session_on_device(r) for r in raw]   # warm every bucket
    jax.block_until_ready([o.rgba for o in warm])
    del warm
    t0 = time.perf_counter()
    outs = [run_session_on_device(r) for r in raw]
    jax.block_until_ready([o.rgba for o in outs])
    dt = time.perf_counter() - t0
    # One aggregated counter read instead of one read per session.
    total = int(jax.jit(lambda *xs: sum(xs))(*[o.n_frames for o in outs]))
    return {"config": "batched_session", "n_logs": len(logs),
            "total_frames": total, "elapsed_s": round(dt, 4),
            "frames_per_sec": round(total / dt, 1)}


def config_streaming(data_dir: Path, mapping: Path, outdir: Path) -> dict:
    from slam_process_tpu.io import read_hex_log
    from slam_process_tpu.io.angles import load_angle_lut
    from slam_process_tpu.parallel.streaming import replay_log
    from slam_process_tpu.parallel.streaming_device import replay_log_device

    logs = _default_logs(data_dir)
    lut = load_angle_lut(mapping)
    raws = [read_hex_log(p) for p in logs]

    # Device-resident state machine (the production streaming path): time
    # everything, then read.
    replay_log_device(raws[0], chunk_bytes=1 << 20).block_until_ready()
    t0 = time.perf_counter()
    sessions = [replay_log_device(r, chunk_bytes=1 << 20) for r in raws]
    for s in sessions:
        s.block_until_ready()
    dev_dt = time.perf_counter() - t0
    import jax

    total = int(jax.jit(lambda *xs: sum(xs))(
        *[s._state.n_frames for s in sessions]))
    sessions[-1].render(lut)

    # Host fallback machine with periodic live renders (no accelerator required).
    t0 = time.perf_counter()
    host_total = 0
    for r in raws:
        s = replay_log(r, chunk_bytes=1 << 16, render_every=8, angle_lut=lut)
        host_total += s.n_frames
    host_dt = time.perf_counter() - t0
    assert host_total == total, (host_total, total)
    return {"config": "streaming_replay", "n_logs": len(logs),
            "total_frames": total,
            "frames_per_sec": round(total / dev_dt, 1),
            "host_frames_per_sec": round(host_total / host_dt, 1)}


NAMED_CONFIGS: Dict[str, Callable] = {
    "serial_hex_to_excel_v3": config_decode,
    "excel_heatmap_v3": config_heatmap,
    "bs_beam_correction": config_correction,
    "batched_session": config_batched,
    "streaming_replay": config_streaming,
}


def run_named_config(name: str, data_dir: Optional[Path] = None,
                     mapping: Optional[Path] = None,
                     outdir: Optional[Path] = None) -> dict:
    if name not in NAMED_CONFIGS:
        raise KeyError(f"unknown config {name!r}; have {sorted(NAMED_CONFIGS)}")
    if data_dir is None or mapping is None:
        # Default input: the generated archive (io/synth.py).
        from slam_process_tpu.io.synth import default_archive

        gen_dir, gen_map = default_archive()
        data_dir = data_dir or gen_dir
        mapping = mapping or gen_map
    data_dir, mapping = Path(data_dir), Path(mapping)
    outdir = Path(outdir or "artifacts/configs")
    outdir.mkdir(parents=True, exist_ok=True)
    return NAMED_CONFIGS[name](data_dir, mapping, outdir)
