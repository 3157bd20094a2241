"""Device-mesh construction for the batched/sharded pipelines.

The reference has no distributed layer at all (SURVEY.md section 2: no
NCCL/MPI/threads); the scaling axis here is sharding batches of
sessions/frames across devices with ``jax.sharding`` + jit.  The
canonical mesh is 2-D:

  * ``data``  — sessions (or frame chunks) are embarrassingly parallel;
  * ``model`` — the estimator dictionary grid (and the 64-beam intensity
    axis) shards across devices for the big correlation matmuls, with
    XLA inserting psum/all-gather (NCCL on GPUs).

The cards of one host are joined all to all (NVLink on the H100), so the
mesh follows the algorithm alone: devices are taken in ``jax.devices()``
order and no physical topology is encoded.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("data", "model"),
    devices=None,
):
    """Build a Mesh over the available devices.

    ``shape=None`` uses all devices on the ``data`` axis with model=1.
    """
    import jax
    from jax.sharding import Mesh

    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {len(devices)}")
    arr = np.asarray(devices[:n]).reshape(shape)
    return Mesh(arr, axis_names=tuple(axis_names))
