"""Worker process for the multi-host streaming test.

Usage: python -m tests._multihost_stream_worker <pid> <nproc>
       <coordinator> <log>

Joins the virtual cluster (4 CPU devices per process, gloo), splits its
log's tokenized bytes into 4 local streams, advances them through ONE
global 8-stream ``MultihostMultiStream`` program (online estimation +
tracking + emit rings armed, one stream finalized EARLY to exercise the
ragged lifecycle collectively), and asserts every local stream's
results/filtered rows/paths/tracks are EXACTLY equal to a single-process
``MultiStreamingSession`` replay of the same chunk schedule.  Exits
non-zero on any mismatch; prints one JSON line on success.
"""

import json
import sys
from pathlib import Path

import numpy as np



def main() -> None:
    pid, nproc = int(sys.argv[1]), int(sys.argv[2])
    coordinator = sys.argv[3]
    log = sys.argv[4]
    mapping = str(Path(log).parent / "beam_angle.xlsx")

    from slam_process_tpu.parallel.multihost import (
        MultihostMultiStream,
        global_data_mesh,
        initialize_multihost,
    )

    initialize_multihost(coordinator_address=coordinator,
                         num_processes=nproc, process_id=pid,
                         local_device_count=4)

    from slam_process_tpu.io import read_hex_log
    from slam_process_tpu.parallel.streaming_device import (
        MultiStreamingSession,
        make_paths_spec,
    )

    tokens = read_hex_log(log)
    n_local = 4
    # 4 distinct local streams from disjoint slices of the log (each a
    # valid byte stream in its own right; parity is vs a replay of the
    # same bytes, not vs the whole-log session).
    sl = len(tokens) // n_local
    streams = [tokens[i * sl:(i + 1) * sl] for i in range(n_local)]
    chunk = 1 << 16
    ecap = sl // 11 + 64
    cp = make_paths_spec(mapping)

    mesh = global_data_mesh(model=1)   # (8,) data over both processes
    kw = dict(chunk_bytes=chunk, collect_paths=cp, emit_capacity=ecap)
    mh = MultihostMultiStream(mesh, n_local, **kw)

    # Same chunk schedule for the single-process oracle.  Stream 0 ends
    # after 2 rounds (finalized EARLY, ragged across the cluster); the
    # rest feed to completion.
    rounds = -(-sl // chunk)
    schedule = []
    for r in range(rounds):
        row = []
        for i in range(n_local):
            if i == 0 and r >= 2:
                row.append(b"")
            else:
                row.append(streams[i][r * chunk:(r + 1) * chunk])
        schedule.append(row)

    for r, row in enumerate(schedule):
        mh.feed(row)
        if r == 1:
            mh.finalize_streams([0])
    mh.finalize()
    # Read the WHOLE multihost state while the processes are still in
    # lockstep: the step dispatches execute lazily, and the local oracle
    # below takes minutes — reading afterwards would make the two
    # processes rendezvous on the deferred collective program minutes
    # apart (observed: gloo context setup DEADLINE_EXCEEDED).
    mh_res = mh.local_results()
    mh_filtered = [mh.local_stream_filtered(i) for i in range(n_local)]
    mh_paths = [mh.local_stream_paths(i) for i in range(n_local)]
    mh_tracks = [mh.local_stream_tracks(i) for i in range(n_local)]

    oracle = MultiStreamingSession(n_local, **kw)
    for r, row in enumerate(schedule):
        oracle.feed(row)
        if r == 1:
            oracle.finalize_streams([0])
    oracle.finalize()

    nf, nk, ng, sums, counts, ovf = mh_res
    onf, onk, ong, osums, ocounts, oovf = oracle.results()
    np.testing.assert_array_equal(nf, onf)
    np.testing.assert_array_equal(nk, onk)
    np.testing.assert_array_equal(ng, ong)
    np.testing.assert_array_equal(sums, osums)
    np.testing.assert_array_equal(counts, ocounts)
    assert not ovf.any() and not np.asarray(oovf).any()

    for i in range(n_local):
        np.testing.assert_array_equal(mh_filtered[i],
                                      oracle.stream_filtered(i))
        est, valid = mh_paths[i]
        oest, ovalid = oracle.stream_paths(i)
        for a, b in zip(est, oest):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(valid, ovalid)
        tr, times, vel = mh_tracks[i]
        otr, otimes, ovel = oracle.stream_tracks(i)
        for a, b in zip(tr[:5], otr[:5]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(times, otimes)
        for a, b in zip(vel, ovel):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    print(json.dumps({"pid": pid, "n_frames": nf.tolist(),
                      "kept": nk.tolist(), "ok": True}), flush=True)


if __name__ == "__main__":
    main()
