"""Multi-process scaling: 2 REAL processes x 4 virtual devices.

The process-spanning batched pipeline (parallel/multihost.py) must
reproduce the single-process results exactly: 2 worker processes join a
gloo-collective cluster, each contributes 2 generated captures to one
(8,)-data-mesh program, and every per-session summary is compared
against this (single) process's oracle run of the same sessions.

This exercises the multi-process code path (process-group init,
host-local -> global array assembly, cross-process collectives) —
SURVEY §5.8's scaling axis beyond a single process.
"""

import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
from tests.conftest import BEAM_ANGLE, DEBUGDOC  # noqa: E402

MAPPING = str(BEAM_ANGLE)

LOGS = [
    DEBUGDOC / "256-0x16-Serial Debug 2026-01-26 164520.txt",
    DEBUGDOC / "Serial Debug 2026-02-06 091211.txt",
    DEBUGDOC / "Serial Debug 2026-02-06 091351.txt",
    DEBUGDOC / "Serial Debug 2026-02-06 091535.txt",
]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_batched_pipeline_matches_single_process():
    for p in LOGS:
        assert p.exists(), p
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = []
    for pid in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests._multihost_worker", str(pid),
             "2", coordinator,
             str(LOGS[2 * pid]), str(LOGS[2 * pid + 1])],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = []
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, stderr[-3000:]
        line = [ln for ln in stdout.splitlines() if ln.startswith("{")][-1]
        outs.append(json.loads(line))
    outs.sort(key=lambda d: d["pid"])

    # Single-process oracle over the same 4 sessions (this process runs
    # on the 8-virtual-device CPU mesh from conftest).
    from slam_process_tpu.io import read_hex_log
    from slam_process_tpu.models.batch_estimation import estimate_sessions
    from slam_process_tpu.pipeline.device import run_session_on_device
    from slam_process_tpu.pipeline.session import Session

    for i, log in enumerate(LOGS):
        ref = run_session_on_device(read_hex_log(log))
        w = outs[i // 2]
        j = i % 2
        assert w["n_frames"][j] == int(ref.n_frames), log
        assert w["n_kept"][j] == int(ref.n_kept), log
        np.testing.assert_allclose(
            w["norm_t_sum"][j], float(np.nansum(np.asarray(ref.norm_t))),
            rtol=0, atol=0)
        assert w["counts_sum"][j] == int(np.asarray(ref.counts).sum()), log

    # Sharded estimation across processes == the single-process vmapped
    # estimator (same flavor + coarse grid the workers used).
    sessions = []
    for log in LOGS:
        s = Session.from_log(log)
        s.correct()
        sessions.append(s)
    est = estimate_sessions(sessions, MAPPING,
                            flavor="v1-7", grid_res=0.5)
    for i in range(len(LOGS)):
        w, j = outs[i // 2], i % 2
        v = np.asarray(est[i].valid, bool)
        assert w["est_n_valid"][j] == int(v.sum()), LOGS[i]
        if v.any():
            assert w["est_aoa0"][j] == float(np.asarray(est[i].aoa)[v][0])
        np.testing.assert_allclose(
            w["est_power_sum"][j],
            float(np.asarray(est[i].power)[v].sum()), rtol=1e-6)


@pytest.mark.slow
def test_two_process_multistream_matches_single_process():
    """Multi-host LIVE INGEST: 2 processes x 4 local streams advance as
    ONE global 8-stream program over the process-spanning mesh — with
    online estimation + tracking, per-stream emit rings, and a ragged
    early finalize — and every stream equals a single-process
    MultiStreamingSession replay of the same bytes (asserted inside each
    worker; this parent checks both workers succeeded and fed real
    frames)."""
    logs = [LOGS[1], LOGS[2]]
    for p in logs:
        assert p.exists(), p
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = []
    for pid in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests._multihost_stream_worker",
             str(pid), "2", coordinator, str(logs[pid])],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = []
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, stderr[-3000:]
        line = [ln for ln in stdout.splitlines() if ln.startswith("{")][-1]
        outs.append(json.loads(line))
    assert all(o["ok"] for o in outs)
    assert all(sum(o["n_frames"]) > 1000 for o in outs), outs


@pytest.mark.slow
def test_two_process_cli_watch_multihost(tmp_path):
    """`cli watch --coordinator`: two REAL processes each tail their own
    GROWING capture, the two streams advance as one global program, one
    capture goes idle early (ragged collective finalize), and each
    process's exported filtered table equals the offline pipeline on its
    file's full contents."""
    import threading
    import time as _time

    from slam_process_tpu.io.schemas import read_filtered_table
    from slam_process_tpu.pipeline.session import Session

    blobs = [LOGS[1].read_bytes(), LOGS[2].read_bytes()[: 400000]]
    grows = [tmp_path / "host_a.txt", tmp_path / "host_b.txt"]
    for g in grows:
        g.write_bytes(b"")

    def writer(path, data, dt):
        _time.sleep(2.0)   # let the cluster come up first
        with open(path, "ab") as f:
            step = len(data) // 8 + 1
            for off in range(0, len(data), step):
                f.write(data[off:off + step])
                f.flush()
                _time.sleep(dt)

    # host_b finishes early and must finalize alone while host_a grows.
    threads = [threading.Thread(target=writer, args=(grows[0], blobs[0], 1.2)),
               threading.Thread(target=writer, args=(grows[1], blobs[1], 0.3))]
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = []
    for pid in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "slam_process_tpu.pipeline.cli",
             "watch", "--logs", str(grows[pid]),
             "--mapping", MAPPING,
             "--outdir", str(tmp_path / f"out{pid}"),
             "--engine", "device",
             "--coordinator", coordinator, "--num-processes", "2",
             "--process-id", str(pid), "--local-devices", "4",
             "--poll-interval", "0.2", "--idle-timeout", "4.0"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    for t in threads:
        t.start()
    outs = []
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=580)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, stderr[-3000:]
        lines = [json.loads(ln) for ln in stdout.splitlines()
                 if ln.startswith("{")]
        outs.append(lines)
    for t in threads:
        t.join()

    for pid, blob in enumerate(blobs):
        src = tmp_path / f"src{pid}.txt"
        src.write_bytes(blob)
        off = Session.from_log(src)
        off.correct()
        outdir = tmp_path / f"out{pid}"
        xlsx = list(outdir.glob("*_filtered.xlsx"))
        assert len(xlsx) == 1, list(outdir.iterdir())
        rows = np.asarray(read_filtered_table(xlsx[0]), dtype=np.int64)
        np.testing.assert_array_equal(
            rows, np.asarray(off.filtered)[:, :rows.shape[1]],
            err_msg=f"process {pid}")
        assert outs[pid][-1]["global_streams"] == 2


@pytest.mark.slow
def test_two_process_cli_watch_multihost_events(tmp_path):
    """Multi-host watch with online estimation and a live events feed:
    each process's JSONL feed equals the offline detector on its own
    capture exactly (local addressable-shard reads only — polling never
    perturbs the cluster's collective lockstep)."""
    import threading
    import time as _time

    from slam_process_tpu.io.hexlog import tokenize_hex
    from slam_process_tpu.models.change_detection import (
        EVENT_KINDS,
        detect_scene_changes_np,
        scene_change_events,
    )
    from slam_process_tpu.parallel.streaming import replay_log
    from slam_process_tpu.parallel.streaming_device import make_paths_spec

    blobs = [LOGS[1].read_bytes()[: 500000],
             LOGS[2].read_bytes()[: 300000]]
    grows = [tmp_path / "ev_a.txt", tmp_path / "ev_b.txt"]
    for g in grows:
        g.write_bytes(b"")

    def writer(path, data, dt):
        _time.sleep(2.0)
        with open(path, "ab") as f:
            step = len(data) // 6 + 1
            for off in range(0, len(data), step):
                f.write(data[off:off + step])
                f.flush()
                _time.sleep(dt)

    threads = [threading.Thread(target=writer, args=(grows[0], blobs[0], 0.8)),
               threading.Thread(target=writer, args=(grows[1], blobs[1], 0.3))]
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = []
    for pid in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "slam_process_tpu.pipeline.cli",
             "watch", "--logs", str(grows[pid]),
             "--mapping", MAPPING,
             "--outdir", str(tmp_path / f"out{pid}"),
             "--engine", "device", "--paths",
             "--events", str(tmp_path / f"events{pid}.jsonl"),
             "--min-persist", "2", "--min-gone", "2", "--jump-deg", "2.0",
             "--coordinator", coordinator, "--num-processes", "2",
             "--process-id", str(pid), "--local-devices", "4",
             # idle-timeout must exceed the worst-case starvation of this
             # test process's writer threads: under full-suite load on the
             # 1-core box a 4 s idle window truncated the capture mid-feed
             # (flaked in-suite, passed in isolation at 9m14s).
             "--poll-interval", "0.2", "--idle-timeout", "15.0"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    for t in threads:
        t.start()
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, stderr[-3000:]
    for t in threads:
        t.join()

    total = 0
    for pid, blob in enumerate(blobs):
        feed = tmp_path / f"events{pid}.jsonl"
        lines = [json.loads(x) for x in feed.read_text().splitlines()
                 if x.strip()]
        keys = [(e["sweep"], e["kind"], e["track"]) for e in lines]
        assert len(keys) == len(set(keys)), f"duplicates, process {pid}"
        s = replay_log(tokenize_hex(blob),
                       collect_paths=make_paths_spec(
                           MAPPING))
        tracks, times, _ = s.path_tracks()
        ev = scene_change_events(
            detect_scene_changes_np(tracks, min_persist=2, min_gone=2,
                                    jump_deg=2.0), tracks, times)
        want = {(int(r[0]), EVENT_KINDS[int(r[2])], int(r[3]))
                for r in ev}
        assert set(keys) == want, f"process {pid}"
        total += len(keys)
    assert total > 0, "vacuous: no events at these thresholds"
