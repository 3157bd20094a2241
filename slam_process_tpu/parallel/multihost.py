"""Multi-process scaling for the batched session pipeline.

The reference has no distributed layer (SURVEY.md §2); within one process
this package scales over the devices it sees with a ``data × model`` mesh
(``parallel/mesh.py``, ``parallel/batch.py``).  This module extends the
same programs across PROCESSES (one or several hosts):

  * :func:`initialize_multihost` — process-group setup with an explicit
    coordinator.  On GPU hosts each process takes only its own cards
    (``local_device_ids``).  For hermetic testing (and CPU-only
    deployments) it pins a virtual cluster: N processes × K virtual CPU
    devices with gloo cross-process collectives — the same code path,
    minus the wire speed.  The GPU multi-process path is not measured.
  * :func:`global_data_mesh` — the canonical ``data × model`` mesh over
    ALL processes' devices (``parallel.mesh.make_mesh`` over
    ``jax.devices()``).
  * :func:`run_batched_multihost` — the batched summary pipeline
    (``parallel.batch.batched_session_pipeline``) over a process-spanning
    mesh: every process contributes its LOCAL sessions, the global
    [S_total, N] array is assembled shard-wise (no session's bytes ever
    leave its host), and each process reads back only its local shard of
    the per-session summaries.
  * :func:`estimate_sessions_multihost` — the sharded flagship NN-OMP
    estimator (sessions over 'data', dictionary grid over 'model') over
    the same process-spanning mesh.
  * :class:`MultihostMultiStream` — multi-host LIVE INGEST: each process
    tails its own captures and all streams advance as one global vmapped
    streaming program (the ``MultiStreamingSession`` state machine with
    its 'data'-sharded stream axis spanning processes), including online
    per-sweep estimation + tracking and per-stream emit rings.

Tested end-to-end in ``tests/test_multihost.py``: two real OS processes
with 4 virtual devices each run the sharded dataset pipeline over an
(8,)-device global mesh and every per-session result equals the
single-process oracle bit-for-bit.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = [
    "initialize_multihost",
    "global_data_mesh",
    "run_batched_multihost",
    "estimate_sessions_multihost",
    "MultihostMultiStream",
    "local_shard",
]


def initialize_multihost(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_count: Optional[int] = None,
    cpu_collectives: str = "gloo",
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Join (or create) the JAX process group.  Call BEFORE any backend
    initializes (before the first jnp/jit touch in the process).

    ``coordinator_address`` (``HOST:PORT`` of process 0), ``num_processes``
    and ``process_id`` are always explicit: nothing auto-detects a cluster.

    Accelerator hosts: ``local_device_ids`` lists the cards this process
    drives (default ``[process_id]``: one card per process, the layout of
    several processes on one machine), so processes sharing a machine do
    not each reserve every card.  Pass all of a host's cards when it runs
    one process.

    Virtual cluster (tests / CPU deployments): also pass
    ``local_device_count``; the process pins that many virtual CPU
    devices and gloo cross-process collectives, then joins the
    coordinator.
    """
    import os

    import jax

    if local_device_count is not None:
        # REPLACE any inherited device-count flag (a worker spawned from
        # the test runner inherits conftest's 8-device XLA_FLAGS).
        flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
                 if "xla_force_host_platform_device_count" not in f]
        flags.append("--xla_force_host_platform_device_count="
                     f"{local_device_count}")
        os.environ["XLA_FLAGS"] = " ".join(flags)
        from slam_process_tpu.utils.cache import ensure_portable_cpu_isa

        ensure_portable_cpu_isa()
        # The config update (effective until backend init) pins the
        # platform even when JAX_PLATFORMS names another.
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_cpu_collectives_implementation",
                          cpu_collectives)
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
        return
    ids = list(local_device_ids if local_device_ids is not None
               else [process_id])
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=ids)


def global_data_mesh(model: int = 1):
    """``data × model`` mesh over every device of every process."""
    import jax

    from slam_process_tpu.parallel.mesh import make_mesh

    n = len(jax.devices())
    assert n % model == 0, (n, model)
    return make_mesh((n // model, model), devices=jax.devices())


def run_batched_multihost(
    mesh,
    raw_list_local: Sequence[np.ndarray],
    n_bytes_padded: Optional[int] = None,
    **pipeline_kwargs,
):
    """Run the batched summary pipeline over a process-spanning mesh.

    ``raw_list_local``: this process's tokenized sessions.  Every process
    must pass the same NUMBER of sessions (pad with a zero-length session
    if ragged — zero bytes decode to zero frames) and call this
    collectively.  The per-session byte bucket is agreed globally
    (all-gather of the local maxima), the [S_total, N] batch is assembled
    with :func:`jax.experimental.multihost_utils.
    host_local_array_to_global_array` — each host's bytes stay on its own
    devices — and the jitted program is the SAME
    ``batched_session_pipeline`` executable the single-host path uses,
    with its 'data'-sharded inputs now spanning processes.

    Returns the global ``SessionSummaryOut`` (shards addressable per
    process — see :func:`local_shard`).
    """
    from jax.experimental import multihost_utils
    from jax.sharding import PartitionSpec as P

    from slam_process_tpu.ops.raster import colormap_lut
    from slam_process_tpu.parallel.batch import (
        batched_session_pipeline,
        stack_sessions,
    )

    local_max = max((len(r) for r in raw_list_local), default=0)
    if n_bytes_padded is None:
        n_bytes_padded = int(np.max(
            multihost_utils.process_allgather(np.int32(local_max))))
    batch, lengths = stack_sessions(raw_list_local, n_bytes_padded)
    batch_g = multihost_utils.host_local_array_to_global_array(
        batch, mesh, P("data", None))
    len_g = multihost_utils.host_local_array_to_global_array(
        lengths, mesh, P("data"))
    lut = np.asarray(colormap_lut("viridis"), np.float32)
    lut_g = multihost_utils.host_local_array_to_global_array(
        lut, mesh, P())
    fn = batched_session_pipeline(mesh, n_bytes_padded,
                                  outputs="summary", **pipeline_kwargs)
    return fn(batch_g, len_g, lut_g)


def estimate_sessions_multihost(
    sessions,
    angle_file,
    mesh,
    flavor: str = "v1-7",
    **overrides,
):
    """Flagship NN-OMP estimation over a process-spanning mesh.

    The multi-host form of ``models.batch_estimation.estimate_sessions
    (..., mesh=...)``: every process preps only ITS sessions (scene pivot
    + dictionary on host), the pad shape is agreed globally, and the SAME
    sharded one-program estimator (sessions over 'data', AoA grid over
    'model') runs once across all hosts.  Call collectively with the same
    number of sessions per process; global N must divide the 'data' axis.

    Returns the global OmpPaths (read this process's rows with
    :func:`local_shard`).
    """
    from jax.experimental import multihost_utils
    from jax.sharding import PartitionSpec as P

    from slam_process_tpu.models.batch_estimation import (
        _batched_nn_omp_sharded_fn,
        flavor_config,
        pack_scenes,
    )
    from slam_process_tpu.models.dictionary import make_dictionary
    from slam_process_tpu.models.registry import build_scene

    dict_cfg, cfg, log_transform, keep_rule, stop_np = flavor_config(
        flavor, **overrides)
    mats, dicts = [], []
    for s in sessions:
        matrix, ue_ang, bs_ang = build_scene(s, angle_file, log_transform)
        mats.append(matrix)
        dicts.append(make_dictionary(ue_ang, bs_ang, dict_cfg))

    local_dims = np.asarray(
        [max(m.shape[0] for m in mats), max(m.shape[1] for m in mats),
         max(len(d.aoa_grid) for d in dicts),
         max(len(d.aod_grid) for d in dicts)], np.int32)
    dims = np.max(multihost_utils.process_allgather(local_dims), axis=0)
    packed = pack_scenes(mats, dicts, pad_to=tuple(dims))

    # Same inert-padding layout as nn_omp_sessions_sharded, applied
    # process-locally so the global arrays agree: the 'model'-sharded Ga
    # axis pads to a multiple of tp with zero-phi columns + edge grid
    # angles (zero-correlation atoms never win a selection).
    tp = mesh.shape.get("model", 1)
    gpad = (-packed.phi_rx.shape[2]) % tp
    phi_rx = np.pad(packed.phi_rx, ((0, 0), (0, 0), (0, gpad)))
    aoa_grid = np.pad(packed.aoa_grid, ((0, 0), (0, gpad)), mode="edge")

    import jax

    n_total = len(sessions) * jax.process_count()
    dp = mesh.shape["data"]
    assert n_total % dp == 0, (
        f"global session count {n_total} must divide the data axis {dp}; "
        "pad every process with a dummy session")
    specs = (P("data", None, None), P("data", None, "model"),
             P("data", None, None), P("data", "model"), P("data", None))
    leaves = (packed.matrices, phi_rx, packed.phi_tx, aoa_grid,
              packed.aod_grid)
    args = tuple(
        multihost_utils.host_local_array_to_global_array(x, mesh, sp)
        for x, sp in zip(leaves, specs))
    fn = _batched_nn_omp_sharded_fn(cfg, keep_rule, stop_np, mesh)
    with mesh:
        return fn(*args)


def local_shard(x) -> np.ndarray:
    """This process's rows of a 'data'-sharded global output, stacked in
    row order (matches the local session order fed in).

    Deduplicates model-axis replicas: on a ``data × model`` mesh a
    'data'-sharded array has one addressable shard per local DEVICE, so
    each data row appears ``model`` times."""
    seen = {}
    for s in x.addressable_shards:
        start = s.index[0].start or 0
        if start not in seen:
            seen[start] = np.asarray(s.data)
    return np.concatenate([seen[k] for k in sorted(seen)], axis=0)


class MultihostMultiStream:
    """Multi-host live ingest: each process tails ``n_local`` streams and
    all ``n_local x process_count`` streams advance as ONE global vmapped
    streaming program over a process-spanning ``data`` mesh.

    The multi-host form of
    :class:`~slam_process_tpu.parallel.streaming_device.MultiStreamingSession`
    (which this reuses wholesale — the step/flush programs are the SAME
    jitted executables, their 'data'-sharded state now spanning processes): a
    deployment where every host owns a set of serial captures runs one
    collective program per chunk round, each host's bytes staying on its
    own devices.  Per-stream results are read back process-locally
    (``local_*`` readers — a process can only address its own shard).

    Contract: every method is COLLECTIVE — all processes call the same
    methods in the same order (``feed`` once per round with their own
    chunks, ``b""`` for idle streams; the window-round count is agreed
    with a process allgather so the lockstep dispatch can never
    diverge).  ``finalize_streams`` takes process-LOCAL indices; passing
    different indices per process is the point (captures end
    independently per host).  Checkpointing and ``reset_streams`` are
    single-host features for now — use one
    :class:`MultiStreamingSession` per host if you need them without the
    global program.

    Exact parity: each stream's results equal a single-process
    ``MultiStreamingSession`` replay of the same bytes
    (tests/test_multihost.py::test_two_process_multistream_*).
    """

    def __init__(
        self,
        mesh,
        n_local: int,
        config=None,
        chunk_bytes: int = 1 << 20,
        group_capacity: int = 8192,
        max_groups: int = 128,
        max_baselines_per_group: int = 192,
        n_beams: int = 64,
        collect_paths=None,
        emit_capacity: int = 0,
    ):
        import jax
        from jax.experimental import multihost_utils
        from jax.sharding import PartitionSpec as P

        from slam_process_tpu.config import PipelineConfig
        from slam_process_tpu.parallel.streaming_device import (
            CARRY_BYTES,
            _build_init,
            _build_multi_flush,
            _build_multi_step,
            frame_capacity,
        )

        self.mesh = mesh
        self.config = config or PipelineConfig()
        self.n_local_real = int(n_local)
        dp = mesh.shape.get("data", 1)
        nproc = jax.process_count()
        # Per-process stream counts may be ragged, and the global count
        # must divide the mesh 'data' axis: agree on a padded per-process
        # count (max over processes, then bumped until P*n divides dp).
        # Padding slots are inert streams that are never fed and never
        # surface in the local_* readers.
        counts = np.asarray(multihost_utils.process_allgather(
            np.int32(self.n_local_real)))
        n_pad = int(counts.max())
        while (n_pad * nproc) % dp:
            n_pad += 1
        self.n_local = n_pad
        self.n_streams = self.n_local * nproc       # incl. padding slots
        self.n_streams_real = int(counts.sum())     # live captures only
        self.chunk_bytes = int(chunk_bytes)
        if self.chunk_bytes <= CARRY_BYTES:
            raise ValueError("chunk_bytes must exceed the 10-byte carry")
        self._carry_bytes = CARRY_BYTES
        self._gcap = int(group_capacity)
        cap = frame_capacity(self.chunk_bytes, self.config.decode)
        if collect_paths is not None:
            spec, dict_args = collect_paths
            self._paths_spec = spec
            self._dict_args = tuple(
                multihost_utils.host_local_array_to_global_array(
                    np.asarray(a, np.float32), mesh, P())
                for a in dict_args)
            ga, gd = len(dict_args[2]), len(dict_args[3])
        else:
            self._paths_spec = None
            self._dict_args = ()
            ga = gd = 0
        self._ecap = int(emit_capacity)
        emit_alloc = (self._ecap + self._gcap
                      + (-(-self.chunk_bytes // 11)) if self._ecap else 0)
        self._step = _build_multi_step(
            cap, self._gcap, max_groups, max_baselines_per_group,
            self.config, self._paths_spec, self._ecap)
        self._flush = _build_multi_flush(
            max_groups, max_baselines_per_group, self.config,
            self._paths_spec, self._ecap)

        # Local state shards -> one global [S, ...] tree.  Every process
        # computes the same deterministic per-stream init, so assembling
        # the local slices yields the exact single-host initial state.
        init1 = _build_init(self._gcap, n_beams, emit_alloc,
                            self._paths_spec, ga, gd)
        local = jax.vmap(lambda _: init1())(np.arange(self.n_local))
        self._state = jax.tree.map(
            lambda x: multihost_utils.host_local_array_to_global_array(
                np.asarray(x), mesh,
                P("data", *([None] * (np.asarray(x).ndim - 1)))),
            local)
        self._byte_carry = [np.zeros(0, np.uint8)
                            for _ in range(self.n_local)]
        self._stream_finalized = np.zeros(self.n_local, bool)
        self._finalized = False
        # Collective WARMUP: compile and execute one empty-window step
        # and one all-False-mask flush (both provable no-ops), blocking
        # until they ran.  The counts allgather above aligned the
        # processes to within milliseconds; warming here means (a) the
        # executables and the runtime's cross-process contexts exist
        # before live data flows, and (b) per-process compile-time skew
        # cannot push the first real dispatch's gloo rendezvous past the
        # runtime's 30 s key-value timeout (observed as a cluster
        # deadlock when pre-grown captures made the first feed and first
        # read race a minutes-long first compile).
        zero_p = multihost_utils.host_local_array_to_global_array(
            np.zeros((self.n_local, self.chunk_bytes), np.uint8), mesh,
            P("data", None))
        zero_l = multihost_utils.host_local_array_to_global_array(
            np.zeros((self.n_local,), np.int32), mesh, P("data"))
        no_mask = multihost_utils.host_local_array_to_global_array(
            np.zeros(self.n_local, bool), mesh, P("data"))
        # Phase 1 — compile WITHOUT executing (populates the persistent
        # compile cache; purely local, no cross-process rendezvous).
        # The two big programs can take minutes to compile on CPU, and
        # the per-process compile-time difference exceeds the gloo
        # rendezvous timeout when the first dispatch follows the compile
        # directly (observed as GetKeyValue DEADLINE_EXCEEDED on one
        # process and a TCP connect timeout on the other).
        self._step.lower(self._state, zero_p, zero_l,
                         self._dict_args).compile()
        self._flush.lower(self._state, no_mask, self._dict_args).compile()
        # Phase 2 — re-align the processes (tiny collective whose
        # contexts already exist from the counts allgather), THEN
        # dispatch the no-op executions so the big programs' collective
        # contexts are created with millisecond skew.
        multihost_utils.process_allgather(np.int32(0))
        self._state = self._step(self._state, zero_p, zero_l,
                                 self._dict_args)
        self._state = self._flush(self._state, no_mask, self._dict_args)
        _ = local_shard(self._state.n_frames)   # block until executed

    # -- collective ingest -------------------------------------------------

    def feed(self, chunks) -> None:
        """Advance this process's streams by one chunk each (COLLECTIVE:
        all processes call feed in the same round; pass ``b""`` for
        streams with no new data)."""
        from jax.experimental import multihost_utils
        from jax.sharding import PartitionSpec as P

        # NOTE: no blanket finalized guard — a process whose local streams
        # all ended must keep calling feed with all-empty chunks so the
        # cluster's collective sequence stays aligned (stepping a
        # finalized stream with an empty piece is a provable no-op); the
        # per-stream check below still rejects real bytes for ended
        # streams.
        if len(chunks) != self.n_local_real:
            raise ValueError(f"expected {self.n_local_real} chunks")
        chunks = list(chunks) + [b""] * (self.n_local - self.n_local_real)
        c = self.chunk_bytes
        bufs, offs = [], []
        for i, chunk in enumerate(chunks):
            if isinstance(chunk, (bytes, bytearray)):
                chunk = np.frombuffer(chunk, dtype=np.uint8)
            chunk = np.asarray(chunk, np.uint8)
            if len(chunk) and self._stream_finalized[i]:
                raise RuntimeError(
                    f"local stream {i} already finalized (pass b'' for "
                    "ended streams)")
            bufs.append(np.concatenate([self._byte_carry[i], chunk]))
            offs.append(0)
        while True:
            go = any(len(b) - o > self._carry_bytes
                     for b, o in zip(bufs, offs))
            # Lockstep rounds: every process must dispatch the same
            # number of step programs, so the continue-decision is a
            # global OR (one tiny allgather per window round).
            go = bool(np.max(multihost_utils.process_allgather(
                np.int32(go))))
            if not go:
                break
            pieces = np.zeros((self.n_local, c), np.uint8)
            lens = np.zeros((self.n_local,), np.int32)
            for i in range(self.n_local):
                n, off = len(bufs[i]), offs[i]
                if n - off > self._carry_bytes:
                    piece = bufs[i][off:off + c]
                    pieces[i, : len(piece)] = piece
                    lens[i] = len(piece)
                    offs[i] = min(off + c, n) - self._carry_bytes
            p_g = multihost_utils.host_local_array_to_global_array(
                pieces, self.mesh, P("data", None))
            l_g = multihost_utils.host_local_array_to_global_array(
                lens, self.mesh, P("data"))
            self._state = self._step(self._state, p_g, l_g,
                                     self._dict_args)
        for i in range(self.n_local):
            self._byte_carry[i] = bufs[i][offs[i]:].copy()

    def _masked_flush(self, mask_local: np.ndarray) -> None:
        from jax.experimental import multihost_utils
        from jax.sharding import PartitionSpec as P

        m_g = multihost_utils.host_local_array_to_global_array(
            np.asarray(mask_local, bool), self.mesh, P("data"))
        self._state = self._flush(self._state, m_g, self._dict_args)
        for i in np.nonzero(mask_local)[0]:
            self._byte_carry[i] = np.zeros(0, np.uint8)

    def finalize_streams(self, local_indices) -> None:
        """Close the open sweep group of this process's given streams
        (COLLECTIVE: every process calls with ITS ended streams, possibly
        none — ragged capture lifecycles across hosts)."""
        idx = np.asarray(list(local_indices), int)
        if idx.size and (idx.min() < 0 or idx.max()
                         >= self.n_local_real):
            raise IndexError(f"stream index out of range: {idx.tolist()}")
        mask = np.zeros(self.n_local, bool)
        if idx.size:
            mask[idx] = True
        already = mask & self._stream_finalized
        if already.any():
            raise RuntimeError(
                f"local streams {np.nonzero(already)[0].tolist()} "
                "already finalized")
        self._masked_flush(mask)
        self._stream_finalized |= mask
        if bool(self._stream_finalized[: self.n_local_real].all()):
            self._finalized = True

    def finalize(self) -> None:
        """Flush every stream still open.

        COLLECTIVE, exactly once per process at shutdown: it always
        dispatches exactly ONE masked flush — with an all-False mask when
        this process has nothing left to close — so ragged clusters
        (some hosts long finished, others closing now) stay in lockstep.
        """
        mask = ~self._stream_finalized
        mask[self.n_local_real:] = False   # inert padding never flushes
        self._masked_flush(mask)
        self._stream_finalized[:] = True
        self._finalized = True

    # -- process-local readers ---------------------------------------------

    def _my_base_row(self) -> int:
        """Global row index of this process's first local stream."""
        return min((sh.index[0].start or 0) for sh in
                   self._state.n_frames.addressable_shards)

    def n_sweeps_closed_all(self) -> np.ndarray:
        """Closed-sweep counts for this process's streams ([n_local_real]
        i64) — a small addressable-shard read, no collective dispatch;
        the live --events poller's cheap has-anything-changed check."""
        if self._paths_spec is None:
            raise ValueError("built without collect_paths")
        return local_shard(self._state.paths.n_closed)[
            : self.n_local_real].astype(np.int64)

    def stream_track_columns(self, i: int, lo: int, hi: int):
        """Local stream ``i``'s track-ring columns for closed sweeps
        ``[lo, hi)`` — the incremental read behind the multi-host live
        ``--events`` feed.

        Uses addressable-shard row slices only (``_local_row_slice``):
        the transfer is O(hi - lo) and nothing collective is dispatched,
        so processes may poll at independent cadences without breaking
        the cluster's lockstep.  Same return contract as
        ``MultiStreamingSession.stream_track_columns``.
        """
        import jax

        p = self._state.paths
        if self._paths_spec is None:
            raise ValueError("built without collect_paths")
        if not (0 <= i < self.n_local_real):
            raise IndexError(f"local stream {i} out of range")
        if bool(local_shard(p.overflow)[i]):
            raise RuntimeError(
                f"online estimation overflow on local stream {i}; "
                "rebuild with larger s_step/capacity")
        g = self._my_base_row() + i
        a, d, pw, ob, tm = jax.device_get((
            _local_row_slice(p.trk_aoa, g, lo, hi),
            _local_row_slice(p.trk_aod, g, lo, hi),
            _local_row_slice(p.trk_pow, g, lo, hi),
            _local_row_slice(p.trk_obs, g, lo, hi),
            _local_row_slice(p.time_ring, g, lo, hi)))
        return (np.asarray(a, np.float32), np.asarray(d, np.float32),
                np.asarray(pw, np.float32), np.asarray(ob, bool),
                np.asarray(tm, np.int64))

    def local_results(self):
        """This process's streams' (n_frames, n_kept, n_groups, sums,
        counts, overflow), leading axis ``n_local_real`` in feed order
        (inert padding slots are sliced off)."""
        s = self._state
        out = tuple(local_shard(x)[: self.n_local_real] for x in (
            s.n_frames, s.n_kept, s.n_groups, s.sums, s.counts,
            s.overflow))
        if bool(np.any(out[5])):
            import warnings

            bad = np.nonzero(np.asarray(out[5]))[0].tolist()
            warnings.warn(
                f"MultihostMultiStream capacity exceeded on local "
                f"streams {bad}; their results are incomplete — rebuild "
                "with larger bounds", RuntimeWarning, stacklevel=2)
        return out

    def local_stream_filtered(self, i: int) -> np.ndarray:
        """Local stream ``i``'s corrected rows [N, 4] in stream order
        (requires ``emit_capacity``)."""
        if not self._ecap:
            raise ValueError("built with emit_capacity=0")
        if not (0 <= i < self.n_local_real):
            raise IndexError(f"local stream {i} out of range")
        buf = local_shard(self._state.emit_buf)[i]
        count = int(local_shard(self._state.emit_count)[i])
        if bool(local_shard(self._state.emit_overflow)[i]):
            raise RuntimeError(
                f"emit ring overflowed on local stream {i} "
                f"(emit_capacity={self._ecap}); rebuild with a larger "
                "emit_capacity")
        return buf[:count].astype(np.int64)

    def local_stream_paths(self, i: int):
        """Local stream ``i``'s online per-sweep estimates (the
        single-stream ``sweep_paths`` contract)."""
        p = self._state.paths
        if self._paths_spec is None:
            raise ValueError("built without collect_paths")
        if not (0 <= i < self.n_local_real):
            raise IndexError(f"local stream {i} out of range")
        if bool(local_shard(p.overflow)[i]):
            raise RuntimeError(
                f"online estimation overflow on local stream {i}; "
                "rebuild with larger s_step/capacity")
        n = int(local_shard(p.n_closed)[i])
        est = type(p.est_rings)(*(local_shard(x)[i][:n]
                                  for x in p.est_rings))
        return est, local_shard(p.valid_ring)[i][:n]

    def local_stream_tracks(self, i: int):
        """Local stream ``i``'s online tracks (the single-stream
        ``path_tracks`` contract)."""
        from slam_process_tpu.models.tracking import (
            Tracks,
            track_velocities,
        )
        from slam_process_tpu.utils.timestamps import unwrap_clk_anchors

        p = self._state.paths
        if self._paths_spec is None:
            raise ValueError("built without collect_paths")
        if not (0 <= i < self.n_local_real):
            raise IndexError(f"local stream {i} out of range")
        if bool(local_shard(p.overflow)[i]):
            raise RuntimeError(
                f"online estimation overflow on local stream {i}; "
                "rebuild with larger s_step/capacity")
        n = int(local_shard(p.n_closed)[i])
        taoa = local_shard(p.trk_aoa)[i][:n]
        taod = local_shard(p.trk_aod)[i][:n]
        tpow = local_shard(p.trk_pow)[i][:n]
        tobs = local_shard(p.trk_obs)[i][:n]
        created = local_shard(p.trk_created)[i]
        count = int(local_shard(p.trk_count)[i])
        tracks = Tracks(taoa.T.copy(), taod.T.copy(), tpow.T.copy(),
                        tobs.T.copy(), created, count)
        times = unwrap_clk_anchors(
            local_shard(p.time_ring)[i][:n].astype(np.int64))
        return tracks, times, track_velocities(tracks, times)


def _local_row_slice(garr, g_row: int, lo: int, hi: int):
    """One row-window ``[g_row, lo:hi]`` of a 'data'-sharded global
    array, via this process's addressable shards ONLY.

    Safe in multiprocess lockstep: reading ``addressable_shards`` and
    slicing a shard's single-device array dispatches nothing collective
    (the slice runs on the owning local device), unlike lazy ops on the
    global array itself, which every process would have to dispatch
    together.  Returns a jax array on the owning device (caller batches
    the ``device_get``).
    """
    for sh in garr.addressable_shards:
        st = sh.index[0].start or 0
        data = sh.data
        if st <= g_row < st + data.shape[0]:
            return data[g_row - st, lo:hi]
    raise IndexError(f"global row {g_row} is not addressable here")
