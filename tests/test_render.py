"""Render/figure-shim tests + CLI end-to-end smoke."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from slam_process_tpu.config import RenderConfig, SceneConfig
from slam_process_tpu.pipeline.session import Session
from slam_process_tpu.render.figures import angle_edges
from tests.conftest import BEAM_ANGLE, REPO_ROOT, SMALL_LOG_2026_02_06


def test_angle_edges_match_reference_rule():
    vals = [1.0, 2.0, 4.0]
    edges = angle_edges(vals)
    np.testing.assert_allclose(edges, [0.5, 1.5, 3.0, 5.0])
    np.testing.assert_allclose(angle_edges([3.0]), [2.5, 3.5])


def test_session_end_to_end(tmp_path):
    s = Session.from_log(SMALL_LOG_2026_02_06)
    s.correct()
    rendered = s.render_heatmap(BEAM_ANGLE, tmp_path / "out.png")
    assert (tmp_path / "out.png").stat().st_size > 10_000
    # Raster orientation: AoD x AoA with full 64-beam coverage.
    assert rendered.rgba.shape == (64, 64, 4)
    assert rendered.aod_angles.shape == (64,)
    # Blur output finite everywhere data existed.
    assert np.isfinite(rendered.blurred).sum() > 3000


def test_figure_cells_match_device_raster(tmp_path):
    """The PNG's heatmap cells must be the device raster colors."""
    s = Session.from_log(SMALL_LOG_2026_02_06)
    s.correct()
    scene_cfg = SceneConfig(keep_nan=True, fill_with_min=False)
    render_cfg = RenderConfig(blur_sigma=1.0, use_log=True)
    rendered = s.render_heatmap(BEAM_ANGLE, None, scene_cfg, render_cfg)

    # Re-color the blurred matrix exactly like the figure shim does
    # (matplotlib norm + cmap) and compare against the device raster.
    import matplotlib
    from matplotlib.colors import LogNorm

    m = rendered.blurred
    finite = np.isfinite(m)
    mn = np.nanmin(m[finite])
    shifted = m - mn + 1e-6
    norm = LogNorm(vmin=np.nanmin(shifted[finite]), vmax=np.nanmax(shifted[finite]))
    cmap = matplotlib.colormaps["viridis"].copy()
    cmap.set_bad((1, 1, 1, 0))
    fig_colors = cmap(norm(np.ma.masked_invalid(shifted)))

    device = rendered.rgba.astype(np.float64) / 255.0
    fa = fig_colors * fig_colors[..., 3:4]
    da = device * device[..., 3:4]
    assert np.max(np.abs(fa - da)) <= 0.5 / 255.0 + 1e-3


@pytest.mark.parametrize("variant", ["v1", "v2", "v3"])
def test_cli_heatmap_variants(tmp_path, variant):
    out = tmp_path / f"heatmap_{variant}.png"
    cmd = [
        sys.executable, "-m", "slam_process_tpu.pipeline.cli", "heatmap",
        "--input", str(SMALL_LOG_2026_02_06),
        "--mapping", str(BEAM_ANGLE),
        "--output", str(out),
        "--variant", variant,
    ]
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO_ROOT,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert out.stat().st_size > 10_000


def test_cli_decode_correct_roundtrip(tmp_path):
    parsed = tmp_path / "parsed.xlsx"
    r = subprocess.run(
        [sys.executable, "-m", "slam_process_tpu.pipeline.cli", "decode",
         str(SMALL_LOG_2026_02_06), str(parsed)],
        capture_output=True, text=True, cwd=REPO_ROOT, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "有效组数=28313" in r.stdout

    r2 = subprocess.run(
        [sys.executable, "-m", "slam_process_tpu.pipeline.cli", "correct",
         "--input", str(parsed), "--output", str(tmp_path / "filtered.xlsx")],
        capture_output=True, text=True, cwd=REPO_ROOT, timeout=300,
    )
    assert r2.returncode == 0, r2.stderr[-2000:]

    from slam_process_tpu.io.schemas import read_filtered_table
    from tests.conftest import FILTERED_2026_02_06

    ours = read_filtered_table(tmp_path / "filtered.xlsx")
    golden = read_filtered_table(FILTERED_2026_02_06)
    np.testing.assert_array_equal(ours, golden)


def test_run_named_config_heatmap(tmp_path):
    from slam_process_tpu.pipeline.configs import run_named_config

    from tests.conftest import BEAM_ANGLE, DEBUGDOC

    result = run_named_config("excel_heatmap_v3", data_dir=DEBUGDOC,
                              mapping=BEAM_ANGLE, outdir=tmp_path)
    assert result["config"] == "excel_heatmap_v3"
    assert Path(result["png"]).stat().st_size > 10_000


def test_run_named_config_unknown():
    import pytest as _pytest

    from slam_process_tpu.pipeline.configs import run_named_config

    with _pytest.raises(KeyError):
        run_named_config("nope")
