"""chip_smoke.py's phases at a tiny size on the CPU.

The script is the on-card proof of the main path; here each phase runs on
two small generated captures (and the four-device phase on four virtual
CPU devices), so a wrong path, argument or comparison shows up before any
card time is spent.  Timings printed here are CPU numbers and mean
nothing; the comparisons are the same as on the card.
"""

import sys

import pytest

from tests.conftest import REPO_ROOT


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(REPO_ROOT))
    import chip_smoke

    return chip_smoke


@pytest.fixture(scope="module")
def ctx(smoke, tmp_path_factory):
    from slam_process_tpu.io import synth

    caps = [synth.capture(21, 9000, 3), synth.capture(22, 5000, 2),
            synth.capture(23, 7000, 3)]
    c = smoke.Ctx(tmp_path_factory.mktemp("smoke"), caps,
                  est_overrides={"grid_res": 1.0}, multi_streams=3,
                  chunk=1 << 14)
    smoke.phase_archive(c)
    return c


def test_phase_environment_on_cpu(smoke, capsys):
    optional = smoke.phase_environment(require_gpu=False)
    assert set(optional) == {"pandas", "matplotlib"}
    out = capsys.readouterr().out
    assert "phase 0-environment ok" in out and "trace planes" in out


def test_phase_environment_refuses_cpu(smoke):
    with pytest.raises(SystemExit, match="no GPU"):
        smoke.phase_environment(require_gpu=True)


def test_phase_archive(ctx):
    assert len(ctx.sessions) == 3
    assert all("device_pipeline" in s.timings for s in ctx.sessions)


def test_phase_estimation(smoke, ctx, capsys):
    smoke.phase_estimation(ctx)
    out = capsys.readouterr().out
    assert "phase 2-estimation ok" in out
    assert "planted vs recovered" in out


def test_phase_streaming_and_cli(smoke, ctx, capsys):
    smoke.phase_streaming(ctx)
    smoke.phase_cli(ctx, have_matplotlib=True)
    out = capsys.readouterr().out
    assert "phase 3-streaming ok" in out and "phase 4-cli ok" in out


def test_phase_cli_without_matplotlib(smoke, ctx, capsys):
    smoke.phase_cli(ctx, have_matplotlib=False)
    assert "not run: matplotlib absent" in capsys.readouterr().out


def test_phase_four_on_virtual_devices(smoke, ctx, capsys):
    smoke.phase_four(ctx, n_dev=4)
    out = capsys.readouterr().out
    assert "phase four ok" in out
    assert "shards on devices [0, 1, 2, 3]" in out


def test_eq_reports_differences(smoke):
    import numpy as np

    smoke._eq("same", np.arange(3), np.arange(3))
    with pytest.raises(AssertionError, match="x: differs"):
        smoke._eq("x", np.arange(3), np.arange(1, 4))
