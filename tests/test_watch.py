"""cli watch: live-tailing a growing log equals the offline pipeline.

A writer thread appends a REAL reference log's text in arbitrary-sized
pieces (deliberately splitting hex tokens across writes); the watch
loop must tokenize incrementally (text carry at the last whitespace),
feed the streaming session, and produce the exact offline filtered
table."""

import sys
import threading
import time
from pathlib import Path

import numpy as np

from tests.conftest import BEAM_ANGLE, SMALL_LOG

LOG = SMALL_LOG
MAPPING = str(BEAM_ANGLE)


import pytest


@pytest.mark.parametrize("engine", [
    "host", pytest.param("device", marks=pytest.mark.slow)])
def test_watch_matches_offline(tmp_path, engine):
    from slam_process_tpu.pipeline.cli import main
    from slam_process_tpu.pipeline.session import Session

    data = LOG.read_bytes()
    grow = tmp_path / "live.txt"
    grow.write_bytes(b"")

    rng = np.random.default_rng(7)
    cuts = np.sort(rng.integers(1, len(data), 24))
    pieces = np.split(np.frombuffer(data, np.uint8), cuts)

    def writer():
        time.sleep(0.3)     # let the watcher start from an empty file
        with open(grow, "ab") as f:
            for p in pieces:
                f.write(p.tobytes())
                f.flush()
                time.sleep(0.05)

    t = threading.Thread(target=writer)
    t.start()
    argv, sys.argv = sys.argv, [
        "cli", "watch", "--log", str(grow), "--mapping", MAPPING,
        "--outdir", str(tmp_path), "--engine", engine,
        "--poll-interval", "0.05", "--idle-timeout", "2.0"]
    try:
        main()
    finally:
        sys.argv = argv
    t.join()

    off = Session.from_log(LOG)
    off.correct()
    from slam_process_tpu.io.schemas import read_filtered_table

    out = tmp_path / "live_filtered.xlsx"
    assert out.exists(), list(tmp_path.iterdir())
    rows = np.asarray(read_filtered_table(out), dtype=np.int64)
    np.testing.assert_array_equal(
        rows, np.asarray(off.filtered)[:, :rows.shape[1]])


@pytest.mark.slow
def test_watch_crash_resume_from_checkpoint(tmp_path):
    """Crash recovery end-to-end: a watch process is SIGKILLed mid-stream,
    a second watch resumes from its periodic checkpoint (device state +
    file offset + tokenizer carry), and the final filtered table equals
    the offline pipeline on the full log exactly."""
    import os
    import signal
    import subprocess

    from slam_process_tpu.io.schemas import read_filtered_table
    from slam_process_tpu.pipeline.cli import main
    from slam_process_tpu.pipeline.session import Session

    data = LOG.read_bytes()
    grow = tmp_path / "live.txt"
    ckpt = tmp_path / "watch.ckpt"
    # Stage 1: half the log is already on disk when the first watch starts.
    grow.write_bytes(data[: len(data) // 2])

    repo = str(Path(__file__).resolve().parent.parent)
    code = (
        "import jax, sys; jax.config.update('jax_platforms', 'cpu');\n"
        "from slam_process_tpu.pipeline.cli import main\n"
        f"sys.argv = ['cli', 'watch', '--log', {str(grow)!r}, "
        f"'--mapping', {MAPPING!r}, '--outdir', {str(tmp_path)!r}, "
        f"'--engine', 'device', '--poll-interval', '0.05', "
        f"'--idle-timeout', '0', '--checkpoint', {str(ckpt)!r}, "
        f"'--checkpoint-every', '0.3']\n"
        "main()\n")
    child = subprocess.Popen([sys.executable, "-c", code], cwd=repo,
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 180
        while not ckpt.exists():
            assert child.poll() is None, "watch process died before saving"
            assert time.monotonic() < deadline, "no checkpoint within 180s"
            time.sleep(0.2)
        time.sleep(1.0)           # let at least one more periodic save land
    finally:
        if child.poll() is None:
            os.kill(child.pid, signal.SIGKILL)
        child.wait()

    # Stage 2: the capture keeps growing after the crash; a new watch
    # resumes from the checkpoint and consumes the rest.
    with open(grow, "ab") as f:
        f.write(data[len(data) // 2:])
    argv, sys.argv = sys.argv, [
        "cli", "watch", "--log", str(grow), "--mapping", MAPPING,
        "--outdir", str(tmp_path), "--engine", "device",
        "--poll-interval", "0.05", "--idle-timeout", "2.0",
        "--checkpoint", str(ckpt)]
    try:
        main()
    finally:
        sys.argv = argv

    off = Session.from_log(LOG)
    off.correct()
    out = tmp_path / "live_filtered.xlsx"
    assert out.exists(), list(tmp_path.iterdir())
    rows = np.asarray(read_filtered_table(out), dtype=np.int64)
    np.testing.assert_array_equal(
        rows, np.asarray(off.filtered)[:, :rows.shape[1]])


@pytest.mark.slow
def test_watch_multi_ragged_idle_matches_offline(tmp_path):
    """watch --logs A B: two growing captures tailed as ONE vmapped
    multi-stream session.  A stops writing early and must finalize ALONE
    on its idle timeout while B keeps growing; both filtered tables equal
    the offline pipeline on each file's full contents."""
    from slam_process_tpu.io.schemas import read_filtered_table
    from slam_process_tpu.pipeline.cli import main
    from slam_process_tpu.pipeline.session import Session

    data = LOG.read_bytes()
    a_total = len(data) // 3
    grow_a = tmp_path / "live_a.txt"
    grow_b = tmp_path / "live_b.txt"
    grow_a.write_bytes(b"")
    grow_b.write_bytes(b"")

    rng = np.random.default_rng(11)
    cuts_a = np.sort(rng.integers(1, a_total, 6))
    pieces_a = np.split(np.frombuffer(data[:a_total], np.uint8), cuts_a)
    cuts_b = np.sort(rng.integers(1, len(data), 16))
    pieces_b = np.split(np.frombuffer(data, np.uint8), cuts_b)

    def writer(path, pieces, dt, delay):
        time.sleep(delay)
        with open(path, "ab") as f:
            for p in pieces:
                f.write(p.tobytes())
                f.flush()
                time.sleep(dt)

    # A finishes its writes quickly, then goes idle; B keeps writing well
    # past A's idle window.
    ta = threading.Thread(target=writer, args=(grow_a, pieces_a, 0.05, 0.3))
    tb = threading.Thread(target=writer, args=(grow_b, pieces_b, 0.45, 0.3))
    ta.start()
    tb.start()
    argv, sys.argv = sys.argv, [
        "cli", "watch", "--logs", str(grow_a), str(grow_b),
        "--mapping", MAPPING, "--outdir", str(tmp_path),
        "--engine", "device", "--poll-interval", "0.05",
        "--idle-timeout", "1.5"]
    try:
        main()
    finally:
        sys.argv = argv
    ta.join()
    tb.join()

    for name, blob in (("live_a", data[:a_total]), ("live_b", data)):
        src = tmp_path / f"{name}_src.txt"
        src.write_bytes(blob)
        off = Session.from_log(src)
        off.correct()
        out = tmp_path / f"{name}_filtered.xlsx"
        assert out.exists(), list(tmp_path.iterdir())
        rows = np.asarray(read_filtered_table(out), dtype=np.int64)
        np.testing.assert_array_equal(
            rows, np.asarray(off.filtered)[:, :rows.shape[1]],
            err_msg=name)


def test_watch_completed_checkpoint_reexports(tmp_path):
    """A crash AFTER finalize (e.g. during export) must not strand the
    capture: re-running the same watch command re-exports the results
    from the finalized checkpoint instead of erroring, and duplicate
    flags (--checkpoint-every without --checkpoint, --emit-capacity 0)
    fail loudly up front."""
    from slam_process_tpu.io.schemas import read_filtered_table
    from slam_process_tpu.pipeline.cli import main
    from slam_process_tpu.pipeline.session import Session

    grow = tmp_path / "live.txt"
    grow.write_bytes(LOG.read_bytes())
    ckpt = tmp_path / "watch.ckpt"
    base = ["cli", "watch", "--log", str(grow), "--mapping", MAPPING,
            "--outdir", str(tmp_path), "--engine", "device",
            "--poll-interval", "0.05", "--idle-timeout", "1.0",
            "--checkpoint", str(ckpt)]

    argv = sys.argv
    try:
        sys.argv = base
        main()                       # completes; saves finalized checkpoint
        out = tmp_path / "live_filtered.xlsx"
        first = np.asarray(read_filtered_table(out), np.int64)
        for f in tmp_path.glob("live_filtered.xlsx"):
            f.unlink()               # simulate a crash that lost the export
        sys.argv = base
        main()                       # must RE-export, not SystemExit
        again = np.asarray(read_filtered_table(out), np.int64)
        np.testing.assert_array_equal(again, first)

        import pytest
        sys.argv = ["cli", "watch", "--log", str(grow), "--mapping",
                    MAPPING, "--outdir", str(tmp_path),
                    "--checkpoint-every", "5"]
        with pytest.raises(SystemExit, match="requires --checkpoint"):
            main()
        sys.argv = base + ["--emit-capacity", "0"]
        with pytest.raises(SystemExit, match="positive"):
            main()
    finally:
        sys.argv = argv

    off = Session.from_log(LOG)
    off.correct()
    np.testing.assert_array_equal(
        first, np.asarray(off.filtered)[:, :first.shape[1]])


def test_watch_live_events_feed(tmp_path):
    """watch --events: scene-change events append LIVE to a JSONL file as
    sweeps close; the final feed has no duplicates and equals the offline
    detector on the full capture exactly."""
    import json

    from slam_process_tpu.models.change_detection import (
        EVENT_KINDS,
        detect_scene_changes_np,
        scene_change_events,
    )
    from slam_process_tpu.parallel.streaming import replay_log
    from slam_process_tpu.parallel.streaming_device import make_paths_spec
    from slam_process_tpu.pipeline.cli import main

    data = LOG.read_bytes()
    grow = tmp_path / "live.txt"
    grow.write_bytes(b"")
    events = tmp_path / "events.jsonl"

    rng = np.random.default_rng(3)
    cuts = np.sort(rng.integers(1, len(data), 12))
    pieces = np.split(np.frombuffer(data, np.uint8), cuts)

    def writer():
        time.sleep(0.3)
        with open(grow, "ab") as f:
            for p in pieces:
                f.write(p.tobytes())
                f.flush()
                time.sleep(0.1)

    t = threading.Thread(target=writer)
    t.start()
    argv, sys.argv = sys.argv, [
        "cli", "watch", "--log", str(grow), "--mapping", MAPPING,
        "--outdir", str(tmp_path), "--engine", "host", "--paths",
        "--events", str(events), "--min-persist", "2", "--min-gone", "2",
        "--jump-deg", "2.0",
        "--poll-interval", "0.05", "--idle-timeout", "2.0"]
    try:
        main()
    finally:
        sys.argv = argv
    t.join()

    lines = [json.loads(x) for x in events.read_text().splitlines()]
    keys = [(e["sweep"], e["kind"], e["track"]) for e in lines]
    assert len(keys) == len(set(keys)), "duplicate live events"
    # Non-vacuous: this capture produces all four event kinds at these
    # thresholds (16 events — checked once offline).
    assert len({e["kind"] for e in lines}) == 4

    # Offline expectation from the same capture with the same thresholds.
    from slam_process_tpu.io import read_hex_log

    s = replay_log(read_hex_log(LOG), collect_paths=make_paths_spec(MAPPING))
    tracks, times, _ = s.path_tracks()
    ev = scene_change_events(
        detect_scene_changes_np(tracks, min_persist=2, min_gone=2,
                                jump_deg=2.0), tracks, times)
    expected = [(int(r[0]), EVENT_KINDS[int(r[2])], int(r[3])) for r in ev]
    assert sorted(keys) == sorted(expected)
    for e, r in zip(sorted(lines, key=lambda x: (x["sweep"], x["kind"],
                                                 x["track"])),
                    sorted(zip(expected, ev), key=lambda x: x[0])):
        assert e["clk"] == int(r[1][1])


def test_watch_events_resume_no_duplicates(tmp_path):
    """A crashed ``watch --events`` resumed from its checkpoint does not
    re-append the pre-crash event rows (the dedup set is seeded from the
    existing feed file), and the final feed still equals the offline
    detector on the full capture — including events whose rows were
    written by the first process."""
    import json
    import os
    import signal
    import subprocess

    from slam_process_tpu.io import read_hex_log
    from slam_process_tpu.models.change_detection import (
        EVENT_KINDS,
        detect_scene_changes_np,
        scene_change_events,
    )
    from slam_process_tpu.parallel.streaming import replay_log
    from slam_process_tpu.parallel.streaming_device import make_paths_spec
    from slam_process_tpu.pipeline.cli import main

    data = LOG.read_bytes()
    grow = tmp_path / "live.txt"
    ckpt = tmp_path / "watch.ckpt"
    events = tmp_path / "events.jsonl"
    grow.write_bytes(data[: len(data) // 2])

    repo = str(Path(__file__).resolve().parent.parent)
    code = (
        "import jax, sys; jax.config.update('jax_platforms', 'cpu');\n"
        "from slam_process_tpu.pipeline.cli import main\n"
        f"sys.argv = ['cli', 'watch', '--log', {str(grow)!r}, "
        f"'--mapping', {MAPPING!r}, '--outdir', {str(tmp_path)!r}, "
        f"'--engine', 'host', '--paths', '--events', {str(events)!r}, "
        f"'--min-persist', '2', '--min-gone', '2', '--jump-deg', '2.0', "
        f"'--poll-interval', '0.05', '--idle-timeout', '0', "
        f"'--checkpoint', {str(ckpt)!r}, '--checkpoint-every', '0.3']\n"
        "main()\n")
    child = subprocess.Popen([sys.executable, "-c", code], cwd=repo,
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 180
        # Wait for a checkpoint AND at least one event row on disk, so the
        # resume genuinely exercises the seeded dedup path.
        while not (ckpt.exists() and events.exists()
                   and events.stat().st_size > 0):
            assert child.poll() is None, "watch process died before saving"
            assert time.monotonic() < deadline, "no checkpoint within 180s"
            time.sleep(0.2)
        time.sleep(1.0)
    finally:
        if child.poll() is None:
            os.kill(child.pid, signal.SIGKILL)
        child.wait()

    pre_crash = [x for x in events.read_text().splitlines() if x.strip()]
    assert pre_crash, "vacuous: no events written before the crash"

    with open(grow, "ab") as f:
        f.write(data[len(data) // 2:])
    # Resume WITHOUT --paths: the checkpoint state carries the online
    # estimation, and the --events gate must defer to it (reconcile).
    argv, sys.argv = sys.argv, [
        "cli", "watch", "--log", str(grow), "--mapping", MAPPING,
        "--outdir", str(tmp_path), "--engine", "host",
        "--events", str(events),
        "--min-persist", "2", "--min-gone", "2", "--jump-deg", "2.0",
        "--poll-interval", "0.05", "--idle-timeout", "2.0",
        "--checkpoint", str(ckpt)]
    try:
        main()
    finally:
        sys.argv = argv

    lines = [json.loads(x) for x in events.read_text().splitlines()
             if x.strip()]
    keys = [(e["sweep"], e["kind"], e["track"]) for e in lines]
    assert len(keys) == len(set(keys)), "duplicate events after resume"

    # Offline expectation on the full capture, same thresholds.
    s = replay_log(read_hex_log(LOG), collect_paths=make_paths_spec(MAPPING))
    tracks, times, _ = s.path_tracks()
    ev = scene_change_events(
        detect_scene_changes_np(tracks, min_persist=2, min_gone=2,
                                jump_deg=2.0), tracks, times)
    want = {(int(r[0]), EVENT_KINDS[int(r[2])], int(r[3])) for r in ev}
    assert set(keys) == want


@pytest.mark.slow
def test_watch_multi_live_events_feed(tmp_path):
    """watch --logs A B --events: ONE live JSONL feed across both
    streams, rows tagged with their stream's session name; per stream it
    has no duplicates and equals the offline detector on that capture's
    full contents (including A, which finalizes alone on idle while B
    keeps growing)."""
    import json

    from slam_process_tpu.models.change_detection import (
        EVENT_KINDS,
        detect_scene_changes_np,
        scene_change_events,
    )
    from slam_process_tpu.parallel.streaming import replay_log
    from slam_process_tpu.parallel.streaming_device import make_paths_spec
    from slam_process_tpu.pipeline.cli import main

    data = LOG.read_bytes()
    a_total = len(data) // 3
    grow_a = tmp_path / "live_a.txt"
    grow_b = tmp_path / "live_b.txt"
    grow_a.write_bytes(b"")
    grow_b.write_bytes(b"")
    events = tmp_path / "events.jsonl"

    rng = np.random.default_rng(13)
    pieces_a = np.split(np.frombuffer(data[:a_total], np.uint8),
                        np.sort(rng.integers(1, a_total, 5)))
    pieces_b = np.split(np.frombuffer(data, np.uint8),
                        np.sort(rng.integers(1, len(data), 12)))

    def writer(path, pieces, dt, delay):
        time.sleep(delay)
        with open(path, "ab") as f:
            for p in pieces:
                f.write(p.tobytes())
                f.flush()
                time.sleep(dt)

    ta = threading.Thread(target=writer, args=(grow_a, pieces_a, 0.05, 0.3))
    tb = threading.Thread(target=writer, args=(grow_b, pieces_b, 0.4, 0.3))
    ta.start()
    tb.start()
    argv, sys.argv = sys.argv, [
        "cli", "watch", "--logs", str(grow_a), str(grow_b),
        "--mapping", MAPPING, "--outdir", str(tmp_path),
        "--engine", "device", "--paths", "--events", str(events),
        "--min-persist", "2", "--min-gone", "2", "--jump-deg", "2.0",
        "--poll-interval", "0.05", "--idle-timeout", "1.5"]
    try:
        main()
    finally:
        sys.argv = argv
    ta.join()
    tb.join()

    lines = [json.loads(x) for x in events.read_text().splitlines()
             if x.strip()]
    keys = [(e["session"], e["sweep"], e["kind"], e["track"])
            for e in lines]
    assert len(keys) == len(set(keys)), "duplicate live events"
    assert {e["session"] for e in lines} == {"live_a", "live_b"}

    from slam_process_tpu.io.hexlog import tokenize_hex

    for name, blob in (("live_a", data[:a_total]), ("live_b", data)):
        s = replay_log(tokenize_hex(blob),
                       collect_paths=make_paths_spec(MAPPING))
        tracks, times, _ = s.path_tracks()
        ev = scene_change_events(
            detect_scene_changes_np(tracks, min_persist=2, min_gone=2,
                                    jump_deg=2.0), tracks, times)
        want = {(name, int(r[0]), EVENT_KINDS[int(r[2])], int(r[3]))
                for r in ev}
        got = {k for k in keys if k[0] == name}
        assert got == want, name


def test_watch_multihost_flag_validation(tmp_path):
    """The multi-host watch flags fail loudly when misused (no cluster is
    ever contacted for these)."""
    from slam_process_tpu.pipeline.cli import main

    log = tmp_path / "x.txt"
    log.write_bytes(b"")
    base = ["cli", "watch", "--mapping", MAPPING,
            "--outdir", str(tmp_path)]

    def run(extra):
        argv, sys.argv = sys.argv, base + extra
        try:
            with pytest.raises(SystemExit) as e:
                main()
            return str(e.value)
        finally:
            sys.argv = argv

    # --num-processes/--process-id without --coordinator
    msg = run(["--log", str(log), "--num-processes", "2"])
    assert "--coordinator" in msg
    # coordinator requires --logs (not --log)
    msg = run(["--log", str(log), "--coordinator", "h:1",
               "--num-processes", "2", "--process-id", "0"])
    assert "--logs" in msg
    # coordinator requires the full process topology
    msg = run(["--logs", str(log), "--engine", "device",
               "--coordinator", "h:1"])
    assert "--num-processes" in msg
    # device engine required
    msg = run(["--logs", str(log), "--coordinator", "h:1",
               "--num-processes", "2", "--process-id", "0"])
    assert "device" in msg
    # checkpoint unsupported on the cluster
    msg = run(["--logs", str(log), "--engine", "device",
               "--coordinator", "h:1", "--num-processes", "2",
               "--process-id", "0", "--checkpoint", str(tmp_path / "c")])
    assert "--checkpoint" in msg
    # events require paths (same rule as single-host)
    msg = run(["--logs", str(log), "--engine", "device",
               "--coordinator", "h:1", "--num-processes", "2",
               "--process-id", "0", "--events", str(tmp_path / "e.jsonl")])
    assert "--paths" in msg
