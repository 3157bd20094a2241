"""Scene change detection over tracks: known-event synthetic scenarios,
numpy == jax bit parity, and the Session/CLI integration surface.

The module under test is beyond-reference (models/change_detection.py);
the oracle is hand-reasoned event semantics on hand-built track
tensors."""

import numpy as np
import pytest

from slam_process_tpu.models.change_detection import (
    EVENT_KINDS,
    detect_scene_changes_jax,
    detect_scene_changes_np,
    scene_change_events,
)
from slam_process_tpu.models.tracking import Tracks


def _mk_tracks(obs, aoa, aod, power):
    obs = np.asarray(obs, bool)
    t_n = obs.shape[0]
    created = obs.any(axis=1)
    # Coasting hold: positions persist between observations (the Tracks
    # invariant the detector relies on).
    pos_a = np.asarray(aoa, np.float32).copy()
    pos_d = np.asarray(aod, np.float32).copy()
    for t in range(t_n):
        last_a, last_d = 0.0, 0.0
        for s in range(obs.shape[1]):
            if obs[t, s]:
                last_a, last_d = pos_a[t, s], pos_d[t, s]
            else:
                pos_a[t, s], pos_d[t, s] = last_a, last_d
    return Tracks(pos_a, pos_d,
                  np.asarray(power, np.float32) * obs,
                  obs, created, int(created.sum()))


def test_birth_death_events():
    # Track 0: observed sweeps 0-5 then gone (death at 6+min_gone-1=8
    # with min_gone=3 -> miss run reaches 3 at sweep 8).
    # Track 1: observed only at sweep 2 (never confirmed; no events).
    s_n = 12
    obs = np.zeros((2, s_n), bool)
    obs[0, 0:6] = True
    obs[1, 2] = True
    aoa = np.zeros((2, s_n), np.float32)
    aod = np.zeros((2, s_n), np.float32)
    power = np.ones((2, s_n), np.float32)
    tr = _mk_tracks(obs, aoa, aod, power)

    ch = detect_scene_changes_np(tr, min_persist=3, min_gone=3)
    birth_t, birth_s = np.nonzero(ch.birth)
    np.testing.assert_array_equal(birth_t, [0])
    np.testing.assert_array_equal(birth_s, [2])   # 3rd observation
    death_t, death_s = np.nonzero(ch.death)
    np.testing.assert_array_equal(death_t, [0])
    np.testing.assert_array_equal(death_s, [8])   # 3rd consecutive miss
    assert not ch.jump.any()


def test_jump_and_los_handover():
    s_n = 10
    obs = np.ones((2, s_n), bool)
    aoa = np.zeros((2, s_n), np.float32)
    aod = np.zeros((2, s_n), np.float32)
    aoa[1] = 20.0
    # Track 0 jumps by 8 deg at sweep 6 (> jump_deg=5).
    aoa[0, 6:] = 8.0
    power = np.ones((2, s_n), np.float32)
    power[0] *= 2.0          # track 0 dominant...
    power[0, 4:] = 0.5       # ...until sweep 4: LoS handover to track 1
    tr = _mk_tracks(obs, aoa, aod, power)

    ch = detect_scene_changes_np(tr, min_persist=3, min_gone=3,
                                 jump_deg=5.0)
    jump_t, jump_s = np.nonzero(ch.jump)
    np.testing.assert_array_equal(jump_t, [0])
    np.testing.assert_array_equal(jump_s, [6])
    np.testing.assert_array_equal(np.nonzero(ch.los_change)[0], [4])
    assert int(ch.los_track[3]) == 0 and int(ch.los_track[4]) == 1

    # Event table: sorted, kinds indexed per EVENT_KINDS.
    times = np.arange(s_n, dtype=np.float64) * 61000
    ev = scene_change_events(ch, tr, times)
    kinds = [EVENT_KINDS[int(k)] for k in ev[:, 2]]
    assert kinds.count("birth") == 2
    assert kinds.count("jump") == 1
    assert kinds.count("los_handover") == 1
    row = ev[ev[:, 2] == 3][0]
    assert row[0] == 4 and row[1] == 4 * 61000 and row[3] == 1


def test_pre_persistence_wobble_is_silent():
    # A track that moves wildly during its first two observations fires
    # no jump (estimator settling), then fires once confirmed.
    s_n = 8
    obs = np.ones((1, s_n), bool)
    aoa = np.zeros((1, s_n), np.float32)
    aoa[0, 1] = 9.0          # pre-confirmation wobble (obs #2)
    aoa[0, 2] = 0.0
    aoa[0, 5:] = 9.0         # post-confirmation jump at sweep 5
    tr = _mk_tracks(obs, aoa, np.zeros_like(aoa), np.ones_like(aoa))
    ch = detect_scene_changes_np(tr, min_persist=3, min_gone=3,
                                 jump_deg=5.0)
    np.testing.assert_array_equal(np.nonzero(ch.jump)[1], [5])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_np_jax_parity(seed):
    import jax

    rng = np.random.default_rng(seed)
    t_n, s_n = 6, 24
    obs = rng.random((t_n, s_n)) < 0.6
    aoa = rng.uniform(-40, 40, (t_n, s_n))
    aod = rng.uniform(-40, 40, (t_n, s_n))
    power = rng.uniform(0.1, 2.0, (t_n, s_n))
    tr = _mk_tracks(obs, aoa, aod, power)

    ref = detect_scene_changes_np(tr, min_persist=2, min_gone=2,
                                  jump_deg=4.0)
    dev = jax.jit(lambda t: detect_scene_changes_jax(
        t, min_persist=2, min_gone=2, jump_deg=4.0))(tr)
    for a, b in zip(ref, dev):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_session_scene_changes_smoke(tmp_path):
    """Integration: events from a real log flow through Session and are
    consistent with the track tensor."""
    from slam_process_tpu.pipeline.session import Session

    from tests.conftest import BEAM_ANGLE, SMALL_LOG_2026_02_06

    log = SMALL_LOG_2026_02_06
    mapping = BEAM_ANGLE
    s = Session.from_log(log)
    events, tracks, times = s.scene_changes(mapping, min_persist=2,
                                            min_gone=2)
    assert events.ndim == 2 and events.shape[1] == 7
    # Every confirmed track (>= 2 observations) must have exactly one
    # birth event; event sweeps must be valid indices.
    n_births = int(np.sum(events[:, 2] == 0))
    confirmed = int(np.sum(np.asarray(
        tracks.observed[: tracks.n_tracks]).sum(axis=1) >= 2))
    assert n_births == confirmed
    assert events.size == 0 or (
        events[:, 0].min() >= 0
        and events[:, 0].max() < tracks.observed.shape[1])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_incremental_equals_batch(seed):
    """IncrementalChangeDetector fed one column at a time reproduces the
    batch scene_change_events table row-for-row — the property the live
    ``watch --events`` feed rests on (O(T) per sweep instead of
    recomputing the whole history per poll)."""
    from slam_process_tpu.models.change_detection import (
        IncrementalChangeDetector,
        detect_scene_changes_np,
        scene_change_events,
    )
    from slam_process_tpu.models.tracking import Tracks, track_paths_np
    from slam_process_tpu.utils.timestamps import (
        ClkUnwrapper,
        unwrap_clk_anchors,
    )

    rng = np.random.default_rng(seed)
    s_n, k_n, t_n = 40, 4, 6
    aoa = rng.uniform(-40, 40, (s_n, k_n)).astype(np.float32)
    aod = rng.uniform(-40, 40, (s_n, k_n)).astype(np.float32)
    power = rng.uniform(0, 1, (s_n, k_n)).astype(np.float32)
    valid = rng.random((s_n, k_n)) < 0.6
    # Correlated sweeps so tracks persist (and die, and jump).
    for s in range(1, s_n):
        hold = rng.random(k_n) < 0.7
        aoa[s] = np.where(hold, aoa[s - 1] + rng.normal(0, 1, k_n)
                          .astype(np.float32), aoa[s])
        aod[s] = np.where(hold, aod[s - 1] + rng.normal(0, 1, k_n)
                          .astype(np.float32), aod[s])
    tracks = track_paths_np(aoa, aod, power, valid, max_tracks=t_n,
                            gate_deg=8.0)
    # Raw CLK anchors with real 2^30 wraps and an empty sweep: 2^28-max
    # increments keep every modular decrease wrap-consistent while the
    # cumulative sum crosses the period several times.
    raw = np.cumsum(rng.integers(1, 1 << 28, s_n)).astype(np.int64)
    assert raw[-1] > (1 << 30), "vacuous: anchors never wrap"
    raw = raw % (1 << 30)
    raw[7] = -1
    times = unwrap_clk_anchors(raw)
    assert times.max() > (1 << 30), "unwrap did not extend past a period"

    batch = scene_change_events(
        detect_scene_changes_np(tracks, min_persist=2, min_gone=2,
                                jump_deg=2.0), tracks, times)

    det = IncrementalChangeDetector(t_n, min_persist=2, min_gone=2,
                                    jump_deg=2.0)
    unwrap = ClkUnwrapper()
    parts = []
    for s in range(s_n):
        t_u = unwrap.push(raw[s])
        parts.append(det.step(tracks.pos_aoa[:, s], tracks.pos_aod[:, s],
                              tracks.power[:, s], tracks.observed[:, s],
                              float(t_u)))
    inc = np.concatenate(parts) if parts else np.zeros((0, 7))
    assert batch.shape == inc.shape
    np.testing.assert_array_equal(batch, inc)
    assert len(batch) > 0, "vacuous: no events produced at these settings"


def test_zero_sweep_tracks_no_events():
    """A zero-sweep session (junk-only stream) must yield empty change
    masks and an empty event table, not an indexing error."""
    from slam_process_tpu.models.change_detection import (
        detect_scene_changes_jax,
        detect_scene_changes_np,
        scene_change_events,
    )
    from slam_process_tpu.models.tracking import Tracks

    t_n = 4
    tracks = Tracks(np.zeros((t_n, 0), np.float32),
                    np.zeros((t_n, 0), np.float32),
                    np.zeros((t_n, 0), np.float32),
                    np.zeros((t_n, 0), bool),
                    np.zeros(t_n, bool), 0)
    for detect in (detect_scene_changes_np, detect_scene_changes_jax):
        ch = detect(tracks)
        assert np.asarray(ch.birth).shape == (t_n, 0)
        assert np.asarray(ch.los_change).shape == (0,)
    ev = scene_change_events(detect_scene_changes_np(tracks), tracks,
                             np.zeros(0, np.int64))
    assert ev.shape == (0, 7)


def test_seed_event_keys_torn_tail(tmp_path):
    """The resume seeder skips malformed feed lines (torn crash tail,
    non-object JSON) without crashing, and quarantines a newline-less
    tail so the next append starts on a fresh line."""
    import json

    from slam_process_tpu.pipeline.cli import _seed_event_keys

    feed = tmp_path / "events.jsonl"
    good = {"sweep": 3, "kind": "birth", "track": 1, "clk": 9,
            "aoa": 0.0, "aod": 0.0, "power": 1.0}
    feed.write_bytes(json.dumps(good).encode() + b"\n"
                     + b"5\n"             # valid JSON, not an object
                     + b"[1, 2]\n"        # ditto
                     + b'{"sweep": 4, "kind": "nope", "track"')  # torn tail
    seen = _seed_event_keys(feed, with_session=False)
    assert seen == {(3, 0, 1)}
    assert feed.read_bytes().endswith(b"\n"), "torn tail not quarantined"
    # Appending after seeding must produce a clean standalone line.
    with open(feed, "a") as f:
        f.write(json.dumps(good) + "\n")
    lines = feed.read_text().splitlines()
    assert json.loads(lines[-1]) == good
