"""Multi-device sharding correctness on the 8-device virtual CPU mesh.

These tests exercise the REAL multi-chip layout (``parallel/batch.py``'s
``in_shardings``/``with_sharding_constraint`` path, which
``__graft_entry__.dryrun_multichip`` compiles) with real logs, asserting
that sharding is a pure layout choice: every output is bit-identical to the
single-device batched run, and matches the host (numpy) oracle pipeline.
Conftest pins JAX to an 8-device virtual CPU platform, so mesh shapes
(8, 1) and (4, 2) both materialize here.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tests.conftest import SMALL_LOG, SMALL_LOG_2026_02_06

# Static capacity bounds sized like bench.py's archive run (generated
# captures have <= 58 groups and up to 4% of a ~4.2k-frame sweep as
# baselines per group — io/synth.py).
MAX_GROUPS = 64
MAX_BASELINES = 192


@pytest.fixture(scope="module")
def two_logs():
    from slam_process_tpu.io import read_hex_log

    return [read_hex_log(SMALL_LOG), read_hex_log(SMALL_LOG_2026_02_06)]


@pytest.fixture(scope="module")
def stacked(two_logs):
    """8 sessions (the two real logs cycled) stacked to [8, N] + lut."""
    from slam_process_tpu.ops.raster import colormap_lut
    from slam_process_tpu.parallel.batch import stack_sessions

    raws = [two_logs[i % 2] for i in range(8)]
    batch, lengths = stack_sessions(raws)
    lut = jnp.asarray(colormap_lut("viridis"))
    return raws, batch, lengths, lut


def _run_batched(mesh_shape, batch, lengths, lut):
    from slam_process_tpu.parallel.batch import batched_session_pipeline
    from slam_process_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(mesh_shape, ("data", "model"))
    fn = batched_session_pipeline(
        mesh, batch.shape[1], max_groups=MAX_GROUPS,
        max_baselines_per_group=MAX_BASELINES,
    )
    with mesh:
        out = fn(jnp.asarray(batch), jnp.asarray(lengths), lut)
        jax.block_until_ready(out.rgba)
    return jax.device_get(out)


@pytest.fixture(scope="module")
def single_device_out(stacked):
    _, batch, lengths, lut = stacked
    return _run_batched((1, 1), batch, lengths, lut)


@pytest.mark.parametrize("mesh_shape", [
    (8, 1), pytest.param((4, 2), marks=pytest.mark.slow)])
def test_sharded_batched_pipeline_bitwise_equals_single_device(
    mesh_shape, stacked, single_device_out
):
    """Data-parallel sharding must not change a single bit of any output."""
    _, batch, lengths, lut = stacked
    sharded = _run_batched(mesh_shape, batch, lengths, lut)
    ref = single_device_out
    for name in sharded._fields:
        a = np.asarray(getattr(sharded, name))
        b = np.asarray(getattr(ref, name))
        np.testing.assert_array_equal(
            a, b, err_msg=f"field {name} differs at mesh {mesh_shape}"
        )


def test_sharded_batched_pipeline_matches_host_oracle(stacked, single_device_out):
    """Each session slice of the sharded run equals the numpy pipeline."""
    from slam_process_tpu.config import SceneConfig
    from slam_process_tpu.ops.correct import correct_frames_np
    from slam_process_tpu.ops.decode import decode_frames_np
    from slam_process_tpu.ops.scene import intensity_grid_np

    raws, _, _, _ = stacked
    out = single_device_out
    for s in (0, 1):   # one slice per unique log
        host = decode_frames_np(raws[s])
        n = int(out.n_frames[s])
        assert n == host.valid
        fv = np.asarray(out.frame_valid[s]).astype(bool)
        assert int(fv.sum()) == n
        np.testing.assert_array_equal(out.frames[s][fv], host.frames)

        res = correct_frames_np(host.frames)
        assert not bool(out.correct_overflow[s])
        np.testing.assert_array_equal(np.asarray(out.keep[s])[fv], res.keep)
        np.testing.assert_array_equal(
            np.asarray(out.corrected_bs[s])[fv], res.corrected_bs)
        assert int(out.n_kept[s]) == len(res.filtered)

        grid = intensity_grid_np(
            res.filtered[:, 0], res.filtered[:, 1], res.filtered[:, 2],
            cfg=SceneConfig(keep_nan=True, fill_with_min=False),
        )
        np.testing.assert_array_equal(out.counts[s], grid.counts)
        np.testing.assert_allclose(
            out.mean_grid[s], grid.mean, rtol=1e-5, atol=1e-3, equal_nan=True
        )


def test_summary_outputs_match_full(stacked, single_device_out):
    """outputs='summary' drops the [S, cap] tensors but changes no value."""
    from slam_process_tpu.parallel.batch import batched_session_pipeline
    from slam_process_tpu.parallel.mesh import make_mesh

    _, batch, lengths, lut = stacked
    mesh = make_mesh((8, 1), ("data", "model"))
    fn = batched_session_pipeline(
        mesh, batch.shape[1], max_groups=MAX_GROUPS,
        max_baselines_per_group=MAX_BASELINES, outputs="summary",
    )
    with mesh:
        out = fn(jnp.asarray(batch), jnp.asarray(lengths), lut)
        jax.block_until_ready(out.rgba)
    for name in out._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(out, name)),
            np.asarray(getattr(single_device_out, name)),
            err_msg=f"summary field {name} differs",
        )


def test_model_parallel_estimator_matches_unsharded(single_device_out):
    """The dryrun's tensor-parallel correlation argmax as a pytest.

    The dictionary-grid axis shards over 'model'; XLA inserts the
    collectives for the global argmax.  Results must equal the unsharded
    einsum exactly.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from slam_process_tpu.models.dictionary import gaussian_beam
    from slam_process_tpu.parallel.mesh import make_mesh

    mesh = make_mesh((4, 2), ("data", "model"))
    grid = np.linspace(-43.6, 45.0, 128).astype(np.float32)
    angles = np.linspace(-43.6, 45.0, 64).astype(np.float32)
    phi = jnp.asarray(gaussian_beam(angles[:, None], grid[None, :], 1.4))

    mats = jnp.nan_to_num(jnp.asarray(single_device_out.mean_grid), nan=0.0)

    def estimate(mean_grid, sharded: bool):
        corr = jnp.einsum("ug,sub,bh->sgh", phi, mean_grid, phi,
                          preferred_element_type=jnp.float32,
                          precision="highest")
        if sharded:
            corr = jax.lax.with_sharding_constraint(
                corr, NamedSharding(mesh, P("data", "model", None))
            )
        flat_idx = jnp.argmax(corr.reshape(corr.shape[0], -1), axis=1)
        return flat_idx, jnp.max(corr, axis=(1, 2))

    with mesh:
        idx_sh, val_sh = jax.jit(lambda m: estimate(m, True))(
            jax.device_put(mats, NamedSharding(mesh, P("data", None, None)))
        )
        jax.block_until_ready(val_sh)
    idx_ref, val_ref = jax.jit(lambda m: estimate(m, False))(mats)
    np.testing.assert_array_equal(np.asarray(idx_sh), np.asarray(idx_ref))
    np.testing.assert_array_equal(np.asarray(val_sh), np.asarray(val_ref))


@pytest.mark.slow
def test_dryrun_multichip_inprocess():
    """The driver's dryrun body must pass on the conftest's 8-device mesh."""
    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(8)


@pytest.mark.slow
def test_grouped_batched_matches_single_device(stacked):
    """run_dataset_batched_grouped (per-bucket programs, empty-session
    padding to the data-axis multiple) == the uniform-padded batched
    pipeline, on the (4,2) virtual mesh."""
    import jax

    from slam_process_tpu.ops.raster import colormap_lut
    from slam_process_tpu.parallel.batch import (
        batched_session_pipeline,
        run_dataset_batched_grouped,
        stack_sessions,
    )
    from slam_process_tpu.parallel.mesh import make_mesh

    raws, _, _, _ = stacked
    mesh = make_mesh((4, 2), ("data", "model"))
    with mesh:
        grouped = run_dataset_batched_grouped(
            mesh, raws, max_groups=64, max_baselines_per_group=96)
        n_padded = max(len(r) for r in raws)
        batch, lengths = stack_sessions(raws, n_padded)
        bfn = batched_session_pipeline(mesh, n_padded, max_groups=64,
                                       max_baselines_per_group=96,
                                       outputs="summary")
        import jax.numpy as jnp

        ref = bfn(batch, lengths, jnp.asarray(colormap_lut("viridis")))
        grouped_h, ref_h = jax.device_get((grouped, ref))
    seen = set()
    for idxs, out in grouped_h:
        for j, s in enumerate(idxs):
            seen.add(s)
            assert int(out.n_frames[j]) == int(ref_h.n_frames[s])
            assert int(out.n_kept[j]) == int(ref_h.n_kept[s])
            assert not bool(out.correct_overflow[j])
            np.testing.assert_array_equal(
                np.nan_to_num(np.asarray(out.norm_t[j])),
                np.nan_to_num(np.asarray(ref_h.norm_t[s])))
            np.testing.assert_array_equal(np.asarray(out.counts[j]),
                                          np.asarray(ref_h.counts[s]))
        # Padding sessions decode to zero frames.
        for j in range(len(idxs), len(np.asarray(out.n_frames))):
            assert int(out.n_frames[j]) == 0
    assert seen == set(range(len(raws)))


def test_sharded_session_estimation_matches_async_and_vmap():
    """Whole-dataset session estimation sharded over a (4, 2) data x model
    mesh == the async per-session dispatch == the unsharded vmap, selection
    sequences and kept paths exactly (two real sessions + zero-pad lanes)."""
    import jax

    from slam_process_tpu.config import DictionaryConfig, OmpConfig
    from slam_process_tpu.io import read_hex_log
    from slam_process_tpu.models.batch_estimation import (
        _batched_nn_omp_fn,
        nn_omp_sessions_device,
        nn_omp_sessions_sharded,
        pack_scenes,
    )
    from slam_process_tpu.models.dictionary import make_dictionary
    from slam_process_tpu.models.registry import build_scene
    from slam_process_tpu.ops.decode import decode_frames_np
    from slam_process_tpu.parallel.mesh import make_mesh
    from slam_process_tpu.pipeline.session import Session
    from tests.conftest import BEAM_ANGLE

    cfg = OmpConfig(max_paths=20, min_power_ratio=0.0003)
    dict_cfg = DictionaryConfig(grid_res=0.4, beam_width=1.4,
                                grid_kind="linspace")
    mats, dicts = [], []
    for p in (SMALL_LOG, SMALL_LOG_2026_02_06):
        s = Session(p.stem)
        s.frames = decode_frames_np(read_hex_log(p)).frames
        matrix, ue_ang, bs_ang = build_scene(s, BEAM_ANGLE, True)
        mats.append(matrix)
        dicts.append(make_dictionary(ue_ang, bs_ang, dict_cfg))
    packed = pack_scenes(mats, dicts)
    mesh = make_mesh((4, 2), ("data", "model"))

    sharded = jax.device_get(
        nn_omp_sessions_sharded(packed, cfg, mesh))
    vmapped = jax.device_get(_batched_nn_omp_fn(cfg, "ratio", True)(
        packed.matrices, packed.phi_rx, packed.phi_tx,
        packed.aoa_grid, packed.aod_grid))
    asyncd = jax.device_get(nn_omp_sessions_device(packed, cfg))

    for i in range(len(mats)):
        vm_i = jax.tree.map(lambda x: x[i], vmapped)
        for o in (vm_i, asyncd[i]):
            ni = int(o.n_iters)
            assert int(sharded.n_iters[i]) == ni
            np.testing.assert_array_equal(sharded.aoa_idx[i][:ni],
                                          o.aoa_idx[:ni])
            np.testing.assert_array_equal(sharded.aod_idx[i][:ni],
                                          o.aod_idx[:ni])
            np.testing.assert_array_equal(sharded.valid[i], o.valid)
            np.testing.assert_allclose(sharded.power[i][:ni],
                                       o.power[:ni], rtol=1e-5, atol=1e-7)


@pytest.mark.slow
def test_multi_stream_session_matches_independent_sessions():
    """8 live streams advanced as ONE vmapped program with the stream
    axis sharded over 'data' == 8 independent DeviceStreamingSessions,
    every per-stream counter and accumulator exactly (uneven stream
    lengths exercise the lockstep no-op windows)."""
    from slam_process_tpu.io import read_hex_log
    from slam_process_tpu.parallel.mesh import make_mesh
    from slam_process_tpu.parallel.streaming_device import (
        MultiStreamingSession,
        replay_log_device,
    )

    raws = [read_hex_log(SMALL_LOG), read_hex_log(SMALL_LOG_2026_02_06)] * 4
    mesh = make_mesh((8, 1), ("data", "model"))
    ms = MultiStreamingSession(8, chunk_bytes=1 << 18, mesh=mesh)
    step = 1 << 17
    for off in range(0, max(len(r) for r in raws), step):
        ms.feed([r[off:off + step] for r in raws])
    ms.finalize()
    nf, nk, ng, sums, counts, ovf = ms.results()
    assert not ovf.any()
    for i, r in enumerate(raws):
        s = replay_log_device(r, chunk_bytes=1 << 18)
        assert int(s._state.n_frames) == int(nf[i])
        assert int(s._state.n_kept) == int(nk[i])
        assert int(s._state.n_groups) == int(ng[i])
        np.testing.assert_array_equal(np.asarray(s._state.sums), sums[i])
        np.testing.assert_array_equal(np.asarray(s._state.counts), counts[i])


@pytest.mark.slow
def test_run_dataset_convenience_matches_per_session(two_logs):
    """run_dataset (the grouped layout's convenience consumer) returns
    per-session summaries in input order, equal to per-session runs."""
    from slam_process_tpu.parallel.batch import run_dataset
    from slam_process_tpu.parallel.mesh import make_mesh
    from slam_process_tpu.pipeline.device import run_session_on_device

    raws = [two_logs[i % 2] for i in range(5)]   # odd count: exercises
    mesh = make_mesh((4, 2), ("data", "model"))  # empty-session padding
    outs = run_dataset(mesh, raws, max_groups=MAX_GROUPS,
                       max_baselines_per_group=MAX_BASELINES)
    assert len(outs) == len(raws)
    for r, o in zip(raws, outs):
        ref = run_session_on_device(r, max_groups=MAX_GROUPS,
                                    max_baselines_per_group=MAX_BASELINES)
        assert int(o.n_frames) == int(ref.n_frames)
        assert int(o.n_kept) == int(ref.n_kept)
        np.testing.assert_array_equal(np.asarray(o.counts),
                                      np.asarray(ref.counts))
        a, b = np.asarray(o.mean_grid), np.asarray(ref.mean_grid)
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        np.testing.assert_allclose(a[np.isfinite(a)], b[np.isfinite(b)],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.slow
def test_multi_stream_emit_matches_single_stream_filtered():
    """Per-stream emit rings: MultiStreamingSession(emit_capacity=...)
    exports each stream's corrected rows exactly equal to the
    single-stream collect_filtered session (and to the offline table)."""
    from slam_process_tpu.io import read_hex_log
    from slam_process_tpu.parallel.streaming_device import (
        MultiStreamingSession,
        replay_log_device,
    )

    raws = [read_hex_log(SMALL_LOG), read_hex_log(SMALL_LOG_2026_02_06)]
    ecap = max(len(r) // 11 + 1 for r in raws)
    ms = MultiStreamingSession(2, chunk_bytes=1 << 18, emit_capacity=ecap)
    step = 1 << 18
    for off in range(0, max(len(r) for r in raws), step):
        ms.feed([r[off:off + step] for r in raws])
    ms.finalize()
    for i, r in enumerate(raws):
        s = replay_log_device(r, chunk_bytes=1 << 18,
                              collect_filtered=True)
        np.testing.assert_array_equal(ms.stream_filtered(i), s.filtered)


@pytest.mark.slow
def test_multi_stream_ragged_finalize_matches_independent_sessions():
    """Live feeds end independently: stream 0 finalizes (its last sweep
    closes and its final ONLINE estimation step runs) while stream 1
    keeps advancing; per-stream results — counters, grids, emit rings,
    online paths, tracks — equal independent single-stream sessions, and
    a finalized stream rejects further bytes."""
    import pytest

    from slam_process_tpu.io import read_hex_log
    from slam_process_tpu.parallel.streaming_device import (
        MultiStreamingSession,
        make_paths_spec,
        replay_log_device,
    )
    from tests.conftest import BEAM_ANGLE

    raw = read_hex_log(SMALL_LOG)
    chunk = 1 << 16
    # Stream 0 ends on a chunk boundary so the lockstep rounds feed
    # stream 1 exactly the same prefix (no overlap with the solo rounds).
    streams = [raw[: 2 * chunk], raw[:180_000]]
    spec = make_paths_spec(BEAM_ANGLE, grid_res=1.0, s_step=16)
    ecap = 1 << 14

    ms = MultiStreamingSession(2, chunk_bytes=chunk, collect_paths=spec,
                               emit_capacity=ecap)
    # Rounds until stream 0's data is exhausted, then finalize it alone.
    for off in range(0, len(streams[0]), chunk):
        ms.feed([s[off:off + chunk] for s in streams])
    ms.finalize_streams([0])
    with pytest.raises(RuntimeError, match="stream 0 already finalized"):
        ms.feed([b"x", b""])
    with pytest.raises(RuntimeError, match="already finalized"):
        ms.finalize_streams([0])
    # Stream 1 continues alone (b"" for the ended stream is a no-op).
    for off in range(len(streams[0]), len(streams[1]), chunk):
        ms.feed([b"", streams[1][off:off + chunk]])
    ms.finalize()

    nf, nk, ng, sums, counts, ovf = ms.results()
    assert not ovf.any()
    for i, r in enumerate(streams):
        ref = replay_log_device(r, chunk_bytes=chunk,
                                collect_paths=spec, collect_filtered=True,
                                emit_capacity=ecap)
        assert int(ref._state.n_frames) == int(nf[i])
        assert int(ref._state.n_kept) == int(nk[i])
        assert int(ref._state.n_groups) == int(ng[i])
        np.testing.assert_array_equal(np.asarray(ref._state.sums), sums[i])
        np.testing.assert_array_equal(np.asarray(ref._state.counts),
                                      counts[i])
        np.testing.assert_array_equal(ms.stream_filtered(i), ref.filtered)
        pa, va = ms.stream_paths(i)
        pb, vb = ref.sweep_paths()
        np.testing.assert_array_equal(va, vb)
        for name in pa._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(pa, name)),
                np.asarray(getattr(pb, name)), err_msg=f"{name}[{i}]")
        ta, tta, _ = ms.stream_tracks(i)
        tb, ttb, _ = ref.path_tracks()
        np.testing.assert_array_equal(tta, ttb)
        for name in ("pos_aoa", "pos_aod", "power", "observed"):
            np.testing.assert_array_equal(
                np.asarray(getattr(ta, name)),
                np.asarray(getattr(tb, name)), err_msg=f"{name}[{i}]")


@pytest.mark.slow
def test_multi_stream_reset_attaches_new_feed():
    """The other half of the ragged lifecycle: after a stream finalizes
    (and its results are read), reset_streams returns the slot to the
    zero state and a NEW feed attaches; both the new feed and the
    untouched sibling equal independent sessions. Resetting a live
    stream raises."""
    import pytest

    from slam_process_tpu.io import read_hex_log
    from slam_process_tpu.parallel.streaming_device import (
        MultiStreamingSession,
        replay_log_device,
    )

    raw = read_hex_log(SMALL_LOG)
    chunk = 1 << 16
    first = raw[: 2 * chunk]              # slot 0's first tenant
    second = raw[100_000:180_000]         # slot 0's new tenant
    sibling = raw                         # slot 1, never interrupted
    ecap = 1 << 15

    ms = MultiStreamingSession(2, chunk_bytes=chunk, emit_capacity=ecap)
    with pytest.raises(RuntimeError, match="still live"):
        ms.reset_streams([0])
    for off in range(0, 2 * chunk, chunk):
        ms.feed([first[off:off + chunk], sibling[off:off + chunk]])
    ms.finalize_streams([0])
    got_first = ms.stream_filtered(0).copy()
    nf_first = int(ms.results()[0][0])

    ms.reset_streams([0])
    off2 = 2 * chunk
    for off in range(0, len(second), chunk):
        ms.feed([second[off:off + chunk],
                 sibling[off2:off2 + chunk]])
        off2 += chunk
    while off2 < len(sibling):
        ms.feed([b"", sibling[off2:off2 + chunk]])
        off2 += chunk
    ms.finalize()

    nf, nk, ng, sums, counts, ovf = ms.results()
    assert not ovf.any()
    for i, r in enumerate([second, sibling]):
        ref = replay_log_device(r, chunk_bytes=chunk,
                                collect_filtered=True, emit_capacity=ecap)
        assert int(ref._state.n_frames) == int(nf[i]), i
        assert int(ref._state.n_kept) == int(nk[i]), i
        assert int(ref._state.n_groups) == int(ng[i]), i
        np.testing.assert_array_equal(np.asarray(ref._state.sums), sums[i])
        np.testing.assert_array_equal(ms.stream_filtered(i), ref.filtered)
    # The first tenant's results (read before the reset) were exact too.
    ref0 = replay_log_device(first, chunk_bytes=chunk,
                             collect_filtered=True, emit_capacity=ecap)
    assert nf_first == int(ref0._state.n_frames)
    np.testing.assert_array_equal(got_first, ref0.filtered)


def test_scan_sessions_bitwise_equals_vmap(stacked, single_device_out):
    """session_axis='scan' (the small-executable form: code size of one
    session regardless of S) must reproduce the vmapped outputs
    bit-exactly."""
    from slam_process_tpu.parallel.batch import batched_session_pipeline
    from slam_process_tpu.parallel.mesh import make_mesh

    _, batch, lengths, lut = stacked
    mesh = make_mesh((1, 1), ("data", "model"))
    fn = batched_session_pipeline(
        mesh, batch.shape[1], max_groups=MAX_GROUPS,
        max_baselines_per_group=MAX_BASELINES, session_axis="scan",
    )
    with mesh:
        out = fn(jnp.asarray(batch), jnp.asarray(lengths), lut)
        jax.block_until_ready(out.rgba)
    out = jax.device_get(out)
    for name in out._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(out, name)),
            np.asarray(getattr(single_device_out, name)),
            err_msg=f"field {name} differs between scan and vmap forms")
