"""Worker process for tests/test_multihost.py.

Usage: python -m tests._multihost_worker <process_id> <num_processes>
       <coordinator> <log1> <log2> ...

Joins the virtual cluster (4 CPU devices per process, gloo collectives),
runs the process-spanning batched pipeline over ITS logs, and prints one
JSON line with this process's local per-session summaries (checksums) so
the parent can compare against the single-process oracle.
"""

import json
from pathlib import Path
import sys


def main() -> None:
    pid, nproc = int(sys.argv[1]), int(sys.argv[2])
    coordinator = sys.argv[3]
    logs = sys.argv[4:]

    from slam_process_tpu.parallel.multihost import (
        global_data_mesh,
        initialize_multihost,
        local_shard,
        run_batched_multihost,
    )

    initialize_multihost(coordinator_address=coordinator,
                         num_processes=nproc, process_id=pid,
                         local_device_count=4)

    from slam_process_tpu.io import read_hex_log

    raws = [read_hex_log(p) for p in logs]
    # (4, 2) data x model over the 8 global devices: 4 sessions, one per
    # data row; each process's 2 sessions live on its own 4 devices.
    mesh = global_data_mesh(model=2)
    out = run_batched_multihost(mesh, raws)

    import numpy as np

    # Sharded flagship estimation across the SAME process-spanning mesh
    # (sessions over 'data', AoA grid over 'model'), coarse grid so the
    # CPU run stays fast.
    from slam_process_tpu.parallel.multihost import (
        estimate_sessions_multihost,
    )
    from slam_process_tpu.pipeline.session import Session

    sessions = [Session.from_log(p) for p in logs]
    for s in sessions:
        s.correct()
    paths = estimate_sessions_multihost(
        sessions, str(Path(logs[0]).parent / "beam_angle.xlsx"), mesh,
        flavor="v1-7", grid_res=0.5)
    aoa = local_shard(paths.aoa)
    valid = local_shard(paths.valid)
    power = local_shard(paths.power)

    print(json.dumps({
        "pid": pid,
        "n_frames": local_shard(out.n_frames).tolist(),
        "n_kept": local_shard(out.n_kept).tolist(),
        "norm_t_sum": np.nansum(local_shard(out.norm_t),
                                axis=(1, 2)).astype(float).tolist(),
        "counts_sum": local_shard(out.counts).sum(
            axis=(1, 2)).astype(int).tolist(),
        "est_n_valid": valid.sum(axis=1).astype(int).tolist(),
        "est_aoa0": [float(a[v][0]) if v.any() else None
                     for a, v in zip(aoa, valid)],
        "est_power_sum": [float(p[v].sum())
                          for p, v in zip(power, valid)],
    }), flush=True)


if __name__ == "__main__":
    main()
