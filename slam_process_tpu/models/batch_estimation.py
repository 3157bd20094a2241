"""Whole-dataset batched estimation: every session through ONE program.

The reference estimates multipaths one session at a time (a fresh Python
process per xlsx — heatmap_gemini_v1-7.py:657-728); the per-session device
engine (models/nn_omp.py) already beats that, but it leaves the matrix
units ~idle:
one session's NN-OMP is a chain of small [Ga,U]x[U,B]x[B,Gd] matmuls.  This
module packs N sessions (or N sessions x S sweeps) into padded tensors and
vmaps the jitted estimator over the whole dataset, so the sequential
``lax.scan`` selection iterations run on thousands of instances at once —
the batching axis, not the tiny per-instance matmul, feeds the matrix units.

Zero-padding exactness: sessions are padded to common (U, B, Ga, Gd) with

  * ``phi_rx``/``phi_tx`` rows (measurement beams) and columns (grid atoms)
    set to 0 past each session's true extent;
  * the measurement matrix padded with 0 (any finite value works — padded
    positions only ever multiply zero ``phi`` rows).

Then for every selection iteration: correlations of padded grid atoms are
identically 0 and padded measurement positions contribute 0 to every
correlation, Gram entry, and right-hand side, so selection order, NNLS
coefficients, and residuals over the REAL extent are the same arithmetic as
the unpadded program.  With ``stop_nonpositive=True`` (the v1-7 rule) a
padded zero-correlation atom can never be selected: selection stops when the
true max drops to <= 0.  With ``stop_nonpositive=False`` (the v1 rule) a
padded atom could win the argmax only when every real correlation is
negative; its coefficient refits to 0, so it is dropped by every keep rule —
the returned *valid* paths still match (documented caveat: the n_iters
counter may differ in that corner).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np

from slam_process_tpu.config import DictionaryConfig, OmpConfig
from slam_process_tpu.models.dictionary import BeamDictionary, make_dictionary
from slam_process_tpu.models.nn_omp import OmpPaths


class PackedScenes(NamedTuple):
    """N sessions padded to a common static shape (device-ready arrays)."""

    matrices: np.ndarray   # [N, U, B] f32 (0 past each session's extent)
    phi_rx: np.ndarray     # [N, U, Ga] (0 rows/cols past the extent)
    phi_tx: np.ndarray     # [N, B, Gd]
    aoa_grid: np.ndarray   # [N, Ga] (edge-padded; padded atoms never selected)
    aod_grid: np.ndarray   # [N, Gd]
    n_ue: np.ndarray       # [N] true U per session
    n_bs: np.ndarray       # [N]
    n_ga: np.ndarray       # [N]
    n_gd: np.ndarray       # [N]


def flavor_config(flavor: str, **overrides):
    """(dict_cfg, omp_cfg, log_transform, keep_rule, stop_nonpositive)
    for a reference estimator flavor — shared by the single-host and
    multi-host dataset runners."""
    if flavor == "v1-7":
        dict_cfg = DictionaryConfig(
            grid_res=overrides.get("grid_res", 0.1),
            beam_width=overrides.get("beam_width", 1.4),
            grid_kind="linspace")
        cfg = OmpConfig(max_paths=overrides.get("max_paths", 20),
                        min_power_ratio=overrides.get("min_power_ratio",
                                                      0.0003))
        return dict_cfg, cfg, True, "ratio", True
    if flavor == "v1":
        dict_cfg = DictionaryConfig(
            grid_res=overrides.get("grid_res", 0.1),
            beam_width=overrides.get("beam_width", 1.4),
            grid_kind="arange")
        cfg = OmpConfig(max_paths=overrides.get("max_paths", 3))
        return dict_cfg, cfg, False, "positive", False
    raise ValueError(f"unknown flavor {flavor!r}")


def pack_scenes(
    matrices: Sequence[np.ndarray],
    dictionaries: Sequence[BeamDictionary],
    pad_to=None,
) -> PackedScenes:
    """Pad per-session scenes + dictionaries to the dataset max shape.

    ``pad_to=(U, B, Ga, Gd)`` overrides the local maxima — the
    multi-host runner uses it so every process packs to the globally
    agreed shape."""
    n = len(matrices)
    U = max(m.shape[0] for m in matrices)
    B = max(m.shape[1] for m in matrices)
    Ga = max(len(d.aoa_grid) for d in dictionaries)
    Gd = max(len(d.aod_grid) for d in dictionaries)
    if pad_to is not None:
        pU, pB, pGa, pGd = (int(x) for x in pad_to)
        assert all(p >= v for p, v in zip((pU, pB, pGa, pGd),
                                          (U, B, Ga, Gd))), (
            pad_to, (U, B, Ga, Gd))
        U, B, Ga, Gd = pU, pB, pGa, pGd

    mats = np.zeros((n, U, B), np.float32)
    prx = np.zeros((n, U, Ga), np.float32)
    ptx = np.zeros((n, B, Gd), np.float32)
    ag = np.zeros((n, Ga), np.float32)
    dg = np.zeros((n, Gd), np.float32)
    dims = np.zeros((4, n), np.int32)
    for i, (m, d) in enumerate(zip(matrices, dictionaries)):
        u, b = m.shape
        ga, gd = len(d.aoa_grid), len(d.aod_grid)
        mats[i, :u, :b] = m
        prx[i, :u, :ga] = d.phi_rx
        ptx[i, :b, :gd] = d.phi_tx
        ag[i, :ga] = d.aoa_grid
        ag[i, ga:] = d.aoa_grid[-1]
        dg[i, :gd] = d.aod_grid
        dg[i, gd:] = d.aod_grid[-1]
        dims[:, i] = (u, b, ga, gd)
    return PackedScenes(mats, prx, ptx, ag, dg, *dims)


@functools.lru_cache(maxsize=16)
def _batched_nn_omp_fn(cfg: OmpConfig, keep_rule: str, stop_np: bool,
                       form: str = "vmap"):
    """ONE compiled program over the session axis — the PRODUCTION
    whole-dataset formulation.

    ``form`` picks the per-session estimator body; every form's selection
    sequences and coefficients equal the float64 oracle's:

    * ``"vmap"`` (default) — vmap(nn_omp_jax) with the Gauss-Jordan NNLS
      subproblem solve (ops/nnls.py ``solver="auto"``) and the
      warm-started Lawson-Hanson refit (each OMP iteration resumes the
      previous (x, passive) instead of re-adding every atom — ~K outer
      iterations per session instead of ~K^2/2).  The pivot-free GJ
      fori_loop replaced ``jnp.linalg.solve``, whose general LU lowers to
      many tiny serialized ops inside both nested NNLS while-loops.
    * ``"gram"`` — vmap of the gram-domain body
      (:func:`~slam_process_tpu.models.nn_omp.nn_omp_gram_batch_jax`,
      one scene per lane): pays the [Ga,U]x[U,B]x[B,Gd] correlation
      chain once up front, but materializes the [Ga,Gd] correlation
      surface (~103 MB at the flagship grid) and re-reads it every
      selection iteration.  Kept as a comparator.

    The choice between them, and against async per-session dispatch
    (:func:`nn_omp_sessions_dispatch`), is not measured on the H100 yet
    (ROADMAP A3).
    """
    import jax

    from slam_process_tpu.models.nn_omp import (
        nn_omp_gram_batch_jax,
        nn_omp_jax,
    )
    from slam_process_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    if form == "gram":
        est = functools.partial(nn_omp_gram_batch_jax, cfg=cfg,
                                keep_rule=keep_rule,
                                stop_nonpositive=stop_np)

        def run(mats, phi_rx, phi_tx, aoa_g, aod_g):
            out = jax.vmap(
                lambda m, rx, tx, a, d: est(rx, tx, a, d, m[None])
            )(mats, phi_rx, phi_tx, aoa_g, aod_g)
            return jax.tree.map(lambda x: x[:, 0], out)
    else:
        est = functools.partial(nn_omp_jax, cfg=cfg, keep_rule=keep_rule,
                                stop_nonpositive=stop_np)

        def run(mats, phi_rx, phi_tx, aoa_g, aod_g):
            return jax.vmap(
                lambda m, rx, tx, a, d: est(rx, tx, a, d, m)
            )(mats, phi_rx, phi_tx, aoa_g, aod_g)

    from slam_process_tpu.utils.precision import jit_highest

    return jit_highest(run)


@functools.lru_cache(maxsize=16)
def _batched_nn_omp_sharded_fn(cfg: OmpConfig, keep_rule: str, stop_np: bool,
                               mesh):
    """The vmapped one-program estimator with mesh shardings: sessions
    over 'data', the AoA dictionary-grid axis over 'model' (the same TP
    layout as the per-sweep sharded path, pipeline/session._sweep_specs).
    The correlation planes and the atom argmax partition over 'model';
    XLA inserts the (tiny) cross-shard argmax/gather collectives."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from slam_process_tpu.models.nn_omp import nn_omp_jax
    from slam_process_tpu.utils.cache import enable_persistent_cache
    from slam_process_tpu.utils.precision import jit_highest

    enable_persistent_cache()
    est = functools.partial(nn_omp_jax, cfg=cfg, keep_rule=keep_rule,
                            stop_nonpositive=stop_np)

    def run(mats, phi_rx, phi_tx, aoa_g, aod_g):
        return jax.vmap(
            lambda m, rx, tx, a, d: est(rx, tx, a, d, m)
        )(mats, phi_rx, phi_tx, aoa_g, aod_g)

    specs = (
        P("data", None, None),      # matrices [N, U, B]
        P("data", None, "model"),   # phi_rx [N, U, Ga]
        P("data", None, None),      # phi_tx [N, B, Gd]
        P("data", "model"),         # aoa_grid [N, Ga]
        P("data", None),            # aod_grid [N, Gd]
    )
    return jit_highest(run, in_shardings=tuple(
        NamedSharding(mesh, s) for s in specs))


def nn_omp_sessions_sharded(
    packed: PackedScenes,
    cfg: OmpConfig,
    mesh,
    keep_rule: str = "ratio",
    stop_nonpositive: bool = True,
):
    """Whole-dataset estimation sharded over the mesh: ONE program, the
    session axis data-parallel and the dictionary grid tensor-parallel.

    This is the formulation that scales past one chip — the async
    per-session dispatch (:func:`nn_omp_sessions_device`) runs each
    session's program on a single device.  Sessions pad to a multiple of
    the 'data' axis with zero scenes (zero phi/matrix: every correlation
    is 0, so selection stops immediately under either stopping rule — the
    padded lanes are inert); the padded results are dropped before return.

    Returns an OmpPaths of [N, ...] DEVICE arrays (one transfer to read).
    """
    import jax

    n = packed.matrices.shape[0]
    dp = mesh.shape["data"]
    tp = mesh.shape.get("model", 1)
    pad = (-n) % dp

    def padn(x):
        return np.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))

    # The sharded Ga axis must divide the 'model' axis: pad with zero phi
    # columns + edge-repeated grid angles — zero-correlation atoms can
    # never win a selection (the pack_scenes exactness argument), so the
    # padded atoms are inert.
    gpad = (-packed.phi_rx.shape[2]) % tp
    phi_rx = np.pad(packed.phi_rx, ((0, 0), (0, 0), (0, gpad)))
    aoa_grid = np.pad(packed.aoa_grid, ((0, 0), (0, gpad)), mode="edge")

    args = (padn(packed.matrices), padn(phi_rx), padn(packed.phi_tx),
            padn(aoa_grid), padn(packed.aod_grid))
    fn = _batched_nn_omp_sharded_fn(cfg, keep_rule, stop_nonpositive, mesh)
    with mesh:
        out = fn(*args)
    return jax.tree.map(lambda x: x[:n], out)


def nn_omp_sessions_device(
    packed: PackedScenes,
    cfg: OmpConfig,
    keep_rule: str = "ratio",
    stop_nonpositive: bool = True,
) -> list:
    """Run N padded sessions as N async dispatches of ONE compiled program.

    NOT the production dataset path (:func:`_batched_nn_omp_fn` is); kept
    for per-session incremental use and as the dispatch comparator.

    Returns a list of N device-resident OmpPaths; transfer with ONE
    ``jax.device_get(list)``.
    """
    from slam_process_tpu.models.nn_omp import _jitted_nn_omp

    fn = _jitted_nn_omp(cfg, keep_rule, stop_nonpositive)
    import jax

    n = packed.matrices.shape[0]
    args = [jax.device_put((packed.phi_rx[i], packed.phi_tx[i],
                            packed.aoa_grid[i], packed.aod_grid[i],
                            packed.matrices[i])) for i in range(n)]
    return [fn(*a) for a in args]


def estimate_sessions(
    sessions,
    angle_file,
    flavor: str = "v1-7",
    **overrides,
) -> list:
    """v1-7 (or v1) NN-OMP over N sessions in one device program.

    Per-session host work is only the scene pivot + dictionary construction;
    the estimation runs as a single vmapped jitted call (the device-plane
    winner — see ``_batched_nn_omp_fn``), optionally mesh-sharded via
    ``mesh=``.  Returns a list of per-session :class:`OmpPaths` (numpy,
    unpadded K slots), equal to ``run_estimator("nn_omp", s, ...,
    engine="device")``'s core output.
    """
    import jax

    from slam_process_tpu.models.registry import build_scene

    dict_cfg, cfg, log_transform, keep_rule, stop_np = flavor_config(
        flavor, **overrides)

    mats, dicts = [], []
    for s in sessions:
        matrix, ue_ang, bs_ang = build_scene(s, angle_file, log_transform)
        mats.append(matrix)
        dicts.append(make_dictionary(ue_ang, bs_ang, dict_cfg))
    packed = pack_scenes(mats, dicts)
    mesh = overrides.get("mesh")
    if mesh is not None:
        out = nn_omp_sessions_sharded(packed, cfg, mesh, keep_rule, stop_np)
    else:
        fn = _batched_nn_omp_fn(cfg, keep_rule, stop_np)
        out = fn(packed.matrices, packed.phi_rx, packed.phi_tx,
                 packed.aoa_grid, packed.aod_grid)
    host = jax.device_get(out)   # one batched pytree transfer
    n = len(sessions)
    return [jax.tree.map(lambda x: x[i], host) for i in range(n)]
