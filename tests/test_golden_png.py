"""Golden-PNG parity: our v1 estimation render vs the shipped pic/ files.

The 10 PNGs in the reference repository's pic/ were produced by heatmap_gemini_v1.py
(filtered xlsx -> pivot -> NN-OMP(max 3) -> RBF contourf -> LoS marker,
dpi 300).  Our render must reproduce them at the full-figure pixel level:
identical canvas size, and only antialiasing-edge pixels (contour/marker
boundaries, driven by f32-vs-f64 interpolation jitter) may deviate.
"""

from pathlib import Path

import numpy as np
import pytest

# Every test here compares with the reference's own artifacts (golden PNGs,
# its debugDoc filtered tables and its beam_angle.xlsx), so each one takes
# the ``require_reference`` fixture and skips without the reference checkout.
pytestmark = pytest.mark.usefixtures("require_reference")


def _ref(*parts) -> Path:
    from tests.conftest import REFERENCE

    return REFERENCE.joinpath(*parts)


def _render(session_stem: str, out_path):
    from slam_process_tpu.models import run_estimator
    from slam_process_tpu.pipeline.session import Session

    s = Session.from_filtered_xlsx(
        _ref("debugDoc", f"{session_stem}_filtered.xlsx"))
    run_estimator("nn_omp_v1", s, _ref("beam_angle.xlsx"), out_path)


@pytest.mark.parametrize("stem", ["2026-01-27 115200"])
def test_golden_pic_parity(tmp_path, stem):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out = tmp_path / "ours.png"
    _render(f"Serial Debug {stem}", out)
    ours = plt.imread(out)
    gold = plt.imread(_ref("pic", f"{stem}.png"))
    assert ours.shape == gold.shape, "figure canvas must match exactly"
    d = np.abs(ours.astype(np.float64) - gold.astype(np.float64))
    assert d.mean() < 1e-4
    assert (d > 1e-3).mean() < 0.005  # only antialiasing edges may move


# Sessions whose golden render is reproducible from the SHIPPED data+code.
# The other 8 pic/ renders predate the current _filtered artifacts: the
# shipped heatmap_gemini_v1.py itself raises KeyError('Column not found:
# RSS') on the shipped 2026-01-26/27 _filtered files (their RSS column is
# named RSS值), several goldens contain NLoS X-markers that the shipped v1
# has commented out, and e.g. the 164520 golden shows an entirely different
# intensity field (LoS at (-1.6, -28.6) vs (1.4, 7.0) from today's data).
# Verified 2026-08-16 by running the reference module against the shipped
# artifacts.  We assert strict parity where the reference is internally
# consistent and structural parity (same canvas, same pipeline) elsewhere.
REPRODUCIBLE = {"2026-01-27 115200", "2026-02-04 115200"}


@pytest.mark.slow
def test_golden_pic_parity_all(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    checked = 0
    for png in sorted(_ref("pic").glob("*.png")):
        stem = png.stem
        src = _ref("debugDoc", f"Serial Debug {stem}_filtered.xlsx")
        if not src.exists():       # no filtered artifact for this render
            continue
        out = tmp_path / f"{stem}.png"
        _render(f"Serial Debug {stem}", out)
        ours = plt.imread(out)
        gold = plt.imread(png)
        assert ours.shape == gold.shape, (stem, "canvas must match exactly")
        if stem in REPRODUCIBLE:
            d = np.abs(ours.astype(np.float64) - gold.astype(np.float64))
            assert d.mean() < 2e-4, stem
            assert (d > 1e-3).mean() < 0.01, stem
        checked += 1
    assert checked


# Both vintages' axes boxes fall inside these windows on the 1500x1200
# canvas (measured: gold spine centers L~100 R~1202 T~55 B~1110).
_BOX_PRIOR = dict(left=(70, 160), right=(1170, 1240), top=(25, 90),
                  bottom=(1080, 1140))


def _detect_axes_box(img, prior=_BOX_PRIOR):
    """(x0, x1, y0, y1) pixel bounds of the axes frame (spine centers).

    The spines are continuous dark lines bounding the plot; within each
    prior window the outermost near-full dark column/row is the spine
    (fully-dark CONTENT columns exist but sit strictly inside the frame).
    """
    gray = np.asarray(img)[..., :3].mean(axis=2)
    dark = gray < 0.6
    yl, yh = prior["top"][0], prior["bottom"][1]
    xl, xh = prior["left"][0], prior["right"][1]

    def line(counts, lo, full_len, outermost_first):
        full = np.nonzero(counts >= 0.95 * full_len)[0]
        if len(full) == 0:
            full = [int(np.argmax(counts))]
        return lo + (full[0] if outermost_first else full[-1])

    x0 = line(dark[yl + 60:yh - 60, slice(*prior["left"])].sum(axis=0),
              prior["left"][0], yh - yl - 120, True)
    x1 = line(dark[yl + 60:yh - 60, slice(*prior["right"])].sum(axis=0),
              prior["right"][0], yh - yl - 120, False)
    y0 = line(dark[slice(*prior["top"]), xl + 60:xh - 60].sum(axis=1),
              prior["top"][0], xh - xl - 120, True)
    y1 = line(dark[slice(*prior["bottom"]), xl + 60:xh - 60].sum(axis=1),
              prior["bottom"][0], xh - xl - 120, False)
    return int(x0), int(x1), int(y0), int(y1)


@pytest.mark.parametrize(
    "stem", [
        "Serial Debug 2026-01-26 164520",
        pytest.param("Serial Debug 2026-01-26 165358", marks=pytest.mark.slow),
        pytest.param("Serial Debug 2026-01-26 170305", marks=pytest.mark.slow),
    ],
)
def test_excel_heatmap_golden_interior_parity(tmp_path, stem):
    """debugDoc/heatmap_outputs goldens (excel_heatmap renders): tight
    pixel parity on the plot interior.

    These were rendered with a LINEAR color scale (colorbar label 线性刻度)
    even though the shipped excel_heatmap.py forces logscale default-on —
    an artifact-vintage drift — and with Windows SimHei, whose label
    metrics give tight_layout a slightly different axes box than this
    (CJK-font-less) environment, so full-canvas text parity is impossible
    here.  The strong font-free oracle: detect the GOLDEN's axes frame,
    render ours pinned to exactly that rect (``axes_rect``), and compare
    the plot interiors pixel-for-pixel (text excluded by construction).
    Measured residuals (2026-08-20): mean|d| 0.0019-0.0020,
    frac(>0.1) 0.6-1.0%, p99 0.055-0.067 across the three goldens —
    antialiasing at cell borders from the golden's different matplotlib
    vintage; a wrong field fails by orders of magnitude.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from slam_process_tpu.config import RenderConfig, SceneConfig
    from slam_process_tpu.pipeline.session import Session

    gold = plt.imread(
        _ref("debugDoc", "heatmap_outputs", f"{stem}_filtered_heatmap.png")
    )
    H, W = gold.shape[:2]
    gx0, gx1, gy0, gy1 = _detect_axes_box(gold)
    rect = (gx0 / W, (H - 1 - gy1) / H, (gx1 - gx0) / W, (gy1 - gy0) / H)

    s = Session.from_filtered_xlsx(_ref("debugDoc", f"{stem}_filtered.xlsx"))
    out = tmp_path / "eh.png"
    s.render_heatmap(
        _ref("beam_angle.xlsx"), out,
        SceneConfig(keep_nan=True, fill_with_min=False),
        RenderConfig(blur_sigma=1.0, use_log=False, dpi=150),
        source="filtered",
        title=f"BS-UE 波束对平均RSSI热力图 ({stem}_filtered.xlsx)",
        axes_rect=rect,
    )
    ours = plt.imread(out)
    assert ours.shape == gold.shape, "figure canvas must match exactly"

    m = 3   # inset past the spine line itself
    hh, ww = gy1 - gy0 - 2 * m, gx1 - gx0 - 2 * m
    o = ours[gy0 + m:gy0 + m + hh, gx0 + m:gx0 + m + ww, :3].astype(np.float64)
    best = None
    for dy in (-1, 0, 1):     # 1-px rasterization rounding of the pin
        for dx in (-1, 0, 1):
            g = gold[gy0 + m + dy:gy0 + m + dy + hh,
                     gx0 + m + dx:gx0 + m + dx + ww, :3].astype(np.float64)
            d = np.abs(g - o)
            if best is None or d.mean() < best.mean():
                best = d
    assert best.mean() < 0.006, f"interior mean|d|={best.mean():.5f}"
    frac = float((best.max(axis=2) > 0.1).mean())
    assert frac < 0.025, f"interior frac(|d|>0.1)={frac:.4f}"
