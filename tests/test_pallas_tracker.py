"""Pallas tracker-block kernel: exact equality with the host oracle.

The kernel (ops/pallas_tracker.py) replays models/tracking's greedy
global-NN association — the streaming step's per-block tracker — in one
launch.  Contract: bit-identical columns/carry to ``track_paths_np``
for lanes < m_eff, under any split of the sweep axis into blocks.  On the
CPU the kernel runs in the Pallas interpreter; the ``gpu``-marked test
runs the Triton-compiled kernel on the card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slam_process_tpu.models.tracking import track_paths_np
from slam_process_tpu.ops.pallas_tracker import track_block_pallas

def _random_case(rng, s_n, k_n, t_n):
    aoa = rng.uniform(-45, 45, (s_n, k_n)).astype(np.float32)
    aod = rng.uniform(-45, 45, (s_n, k_n)).astype(np.float32)
    pw = rng.uniform(0, 1, (s_n, k_n)).astype(np.float32)
    val = rng.random((s_n, k_n)) < 0.6
    return aoa, aod, pw, val


def _run_blocks(aoa, aod, pw, val, t_n, gate, s1, splits, interpret):
    """Feed the sweeps through the kernel in consecutive blocks."""
    pos = jnp.zeros((t_n, 2), jnp.float32)
    created = jnp.zeros((t_n,), bool)
    count = jnp.int32(0)
    cols = []
    off = 0
    for m in splits:
        blk = lambda a: np.concatenate(
            [a[off:off + m],
             np.zeros((s1 - m,) + a.shape[1:], a.dtype)])
        oa, od, op, oo, pos, created, count = track_block_pallas(
            blk(aoa), blk(aod), blk(pw), blk(val.astype(np.int32)),
            jnp.int32(m), pos, created, count, gate_deg=gate,
            interpret=interpret)
        cols.append(tuple(np.asarray(o)[:m] for o in (oa, od, op, oo)))
        off += m
    out = [np.concatenate([c[i] for c in cols]) for i in range(4)]
    return out, np.asarray(pos), np.asarray(created), int(count)


@pytest.mark.parametrize("seed", [
    0, pytest.param(1, marks=pytest.mark.slow),
    pytest.param(2, marks=pytest.mark.slow)])
def test_kernel_matches_oracle_single_block(seed):
    rng = np.random.default_rng(seed)
    for _ in range(8):
        s_n = int(rng.integers(1, 24))
        k_n = int(rng.integers(1, 6))
        t_n = int(rng.integers(2, 10))
        gate = float(rng.uniform(3, 30))
        aoa, aod, pw, val = _random_case(rng, s_n, k_n, t_n)
        ref = track_paths_np(aoa, aod, pw, val, max_tracks=t_n,
                             gate_deg=gate)
        s1 = s_n + int(rng.integers(0, 4))
        (oa, od, op, oo), pos, created, count = _run_blocks(
            aoa, aod, pw, val, t_n, gate, s1, [s_n],
            interpret=True)
        assert np.array_equal(oa.T, ref.pos_aoa)
        assert np.array_equal(od.T, ref.pos_aod)
        assert np.array_equal(op.T, ref.power)
        assert np.array_equal(oo.T, ref.observed)
        assert np.array_equal(created, ref.created)
        assert count == ref.n_tracks


def test_kernel_block_split_invariance():
    """Any split of the sweep axis gives the same columns and carry —
    the property the streaming step relies on (sweeps close in
    arbitrary per-window counts)."""
    rng = np.random.default_rng(42)
    s_n, k_n, t_n, gate, s1 = 30, 3, 8, 10.0, 12
    aoa, aod, pw, val = _random_case(rng, s_n, k_n, t_n)
    ref = track_paths_np(aoa, aod, pw, val, max_tracks=t_n, gate_deg=gate)
    for _ in range(5):
        splits = []
        left = s_n
        while left > 0:
            m = int(rng.integers(0, min(s1, left) + 1))
            if m == 0 and left <= s1:
                m = left
            splits.append(m)
            left -= m
        (oa, od, op, oo), pos, created, count = _run_blocks(
            aoa, aod, pw, val, t_n, gate, s1, splits,
            interpret=True)
        assert np.array_equal(oa.T, ref.pos_aoa), splits
        assert np.array_equal(od.T, ref.pos_aod), splits
        assert np.array_equal(op.T, ref.power), splits
        assert np.array_equal(oo.T, ref.observed), splits
        assert np.array_equal(created, ref.created), splits
        assert count == ref.n_tracks, splits


def test_kernel_meff_zero_is_carry_noop():
    rng = np.random.default_rng(5)
    t_n, k_n, s1 = 8, 3, 16
    aoa, aod, pw, val = _random_case(rng, s1, k_n, t_n)
    pos = jnp.asarray(rng.uniform(-45, 45, (t_n, 2)).astype(np.float32))
    created = jnp.asarray(rng.random(t_n) < 0.5)
    count = jnp.int32(int(np.sum(np.asarray(created))))
    oa, od, op, oo, npos, ncreated, ncount = track_block_pallas(
        aoa, aod, pw, val.astype(np.int32), jnp.int32(0), pos, created,
        count, gate_deg=10.0, interpret=True)
    assert np.array_equal(np.asarray(npos), np.asarray(pos))
    assert np.array_equal(np.asarray(ncreated), np.asarray(created))
    assert int(ncount) == int(count)


@pytest.mark.gpu
def test_kernel_on_chip_non_interpreted(require_gpu):
    """On-card sentinel: the Triton-compiled kernel is exact at the
    production shape (s1=65, K=3, T=8)."""
    rng = np.random.default_rng(11)
    s_n, k_n, t_n = 65, 3, 8
    aoa, aod, pw, val = _random_case(rng, s_n, k_n, t_n)
    for meff in (65, 15, 1):
        ref = track_paths_np(aoa[:meff], aod[:meff], pw[:meff], val[:meff],
                             max_tracks=t_n, gate_deg=10.0)
        oa, od, op, oo, npos, ncreated, ncount = track_block_pallas(
            aoa, aod, pw, val.astype(np.int32), jnp.int32(meff),
            jnp.zeros((t_n, 2), jnp.float32), jnp.zeros((t_n,), bool),
            jnp.int32(0), gate_deg=10.0, interpret=False)
        assert np.array_equal(np.asarray(oa)[:meff].T, ref.pos_aoa)
        assert np.array_equal(np.asarray(od)[:meff].T, ref.pos_aod)
        assert np.array_equal(np.asarray(op)[:meff].T, ref.power)
        assert np.array_equal(np.asarray(oo)[:meff].T, ref.observed)
        assert np.array_equal(np.asarray(ncreated), ref.created)
        assert int(ncount) == ref.n_tracks
