"""Sequence-scaling demonstration: device streaming over an unbounded log.

The reference slurps whole files; deployment streams are arbitrarily long
(SURVEY §5.7).  This repeats one seeded capture (``io.synth``) into a
multi-hundred-MB 11-byte-format stream in bounded host memory and replays it through the device-resident
streaming session, reporting throughput per 64 MiB segment — flat
throughput (no growth in per-byte cost, no host accumulation) is the
scaling claim.  The device state stays O(group_capacity) regardless of
stream length.

Usage: python tools/bench_streaming_scale.py [total_mb]
"""

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from slam_process_tpu.io.synth import capture  # noqa: E402
from slam_process_tpu.parallel.streaming_device import (  # noqa: E402
    DeviceStreamingSession,
)

TOTAL_MB = int(sys.argv[1]) if len(sys.argv) > 1 else 256
SEGMENT = 64 << 20


def synth_segment(base: np.ndarray, n_bytes: int) -> np.ndarray:
    """``n_bytes`` (rounded down to whole captures) of one capture repeated."""
    return np.tile(base, max(1, n_bytes // len(base)))


def main():
    base = capture(0, 100_000, 30).wire
    s = DeviceStreamingSession(chunk_bytes=1 << 22, group_capacity=8192,
                               max_groups=512)
    # Warm compile on one small segment.
    s.feed(base)
    s.block_until_ready()

    total = 0
    t_all = time.perf_counter()
    while total < TOTAL_MB << 20:
        t0 = time.perf_counter()
        seg = synth_segment(base, SEGMENT)
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        s.feed(seg)
        s.block_until_ready()
        dt = time.perf_counter() - t0
        total += len(seg)
        print(f"{total >> 20:5d} MiB: {len(seg)/11/dt/1e6:7.1f} M frames/s "
              f"(segment feed {dt*1e3:6.1f} ms; host synth {gen_s*1e3:.0f} ms)")
    s.finalize()
    wall = time.perf_counter() - t_all
    n = s.n_frames
    print(f"total: {n} frames, {total/1e6:.0f} MB, overflow={s.overflow}, "
          f"kept={s.n_kept}, groups={s.n_groups}")
    print(f"device-feed throughput excludes host synthesis; "
          f"wall incl. synthesis: {n/wall/1e6:.1f} M frames/s")


if __name__ == "__main__":
    main()
