"""Worker process for the driver's multi-host dry run.

Usage: python -m slam_process_tpu.parallel._dryrun_worker <pid> <nproc>
       <coordinator>

Joins a 2-virtual-device-per-process gloo cluster and advances 2 local
synthetic streams through ONE global ``MultihostMultiStream`` window round
(the process-spanning collective live-ingest path).  Prints one JSON line on success; exits non-zero otherwise.

Spawned by ``__graft_entry__.dryrun_multichip`` so the multi-host ingest
program is compile+execute-validated by the round driver without real
multi-host hardware (mirrors tests/_multihost_stream_worker.py, which
additionally asserts exact per-stream parity in the slow suite).
"""

from __future__ import annotations

import json
import sys

import numpy as np

from slam_process_tpu.io.synth import capture


def main() -> None:
    pid, nproc = int(sys.argv[1]), int(sys.argv[2])
    coordinator = sys.argv[3]

    from slam_process_tpu.parallel.multihost import (
        MultihostMultiStream,
        global_data_mesh,
        initialize_multihost,
    )

    initialize_multihost(coordinator_address=coordinator,
                         num_processes=nproc, process_id=pid,
                         local_device_count=2)

    n_local = 2
    mesh = global_data_mesh(model=1)   # (2*nproc,) data over all processes
    mh = MultihostMultiStream(mesh, n_local, chunk_bytes=4096,
                              group_capacity=1024, max_groups=8,
                              max_baselines_per_group=16)

    streams = [capture(10 * pid + i, 180, 1).wire.tobytes()
               for i in range(n_local)]
    # Two feed rounds then a collective finalize: exercises the lockstep
    # window agreement, the sharded step program, and the flush path.
    half = len(streams[0]) // 2
    mh.feed([s[:half] for s in streams])
    mh.feed([s[half:] for s in streams])
    mh.finalize()
    nf, _nk, ng, _sums, _counts, ovf = mh.local_results()
    n_frames = [int(v) for v in np.asarray(nf)]
    ok = all(v > 0 for v in n_frames) and not np.asarray(ovf).any()
    print(json.dumps({"pid": pid, "ok": ok, "n_frames": n_frames}),
          flush=True)
    sys.exit(0 if ok else 3)


if __name__ == "__main__":
    main()
