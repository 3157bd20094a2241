"""CJK font discovery/registration (render/fonts.py).

The test machines ship no CJK font,
so the bundling mechanism is proven with a synthesized TTF that covers the
reference-title codepoints: dropping a font into assets/fonts/ (or naming
one via SLAM_PROCESS_TPU_CJK_FONT) must register it with matplotlib, make
CJK titles render without missing-glyph fallbacks, and flip the
reference's unicode_minus setting; without a font, rcParams stay at
matplotlib defaults (the pic/ golden renders depend on them).
"""

import warnings
from pathlib import Path

import numpy as np
import pytest

# Characters from the reference figure chrome (excel_heatmap.py titles,
# plus the axis/colorbar labels that save_heatmap_figure draws by default).
PROBE_TEXT = "波束对平均RSSI热力图"
CHROME_TEXT = PROBE_TEXT + "AoA（UE侧，度）AoD（BS侧，度）RSSI强度对数刻度线性"


def _synthesize_cjk_font(path: Path) -> None:
    """Minimal TTF with real (box) outlines for the probe codepoints."""
    from fontTools.fontBuilder import FontBuilder
    from fontTools.pens.ttGlyphPen import TTGlyphPen

    cps = sorted({ord(c) for c in CHROME_TEXT} | set(range(0x20, 0x7F)))
    glyph_order = [".notdef"] + [f"uni{cp:04X}" for cp in cps]
    fb = FontBuilder(1000, isTTF=True)
    fb.setupGlyphOrder(glyph_order)
    fb.setupCharacterMap({cp: f"uni{cp:04X}" for cp in cps})

    def box():
        pen = TTGlyphPen(None)
        pen.moveTo((100, 0))
        pen.lineTo((100, 700))
        pen.lineTo((600, 700))
        pen.lineTo((600, 0))
        pen.closePath()
        return pen.glyph()

    fb.setupGlyf({name: box() for name in glyph_order})
    fb.setupHorizontalMetrics({name: (700, 100) for name in glyph_order})
    fb.setupHorizontalHeader(ascent=800, descent=-200)
    fb.setupNameTable({"familyName": "SynthCJK", "styleName": "Regular"})
    fb.setupOS2(sTypoAscender=800, sTypoDescender=-200, usWinAscent=800,
                usWinDescent=200)
    fb.setupPost()
    fb.save(str(path))


@pytest.fixture
def rc_guard():
    import matplotlib

    from slam_process_tpu.render import fonts

    saved = matplotlib.rcParams.copy()
    fonts.setup_cjk_font.cache_clear()
    yield
    fonts.setup_cjk_font.cache_clear()
    dict.update(matplotlib.rcParams, saved)


def test_no_font_keeps_matplotlib_defaults(rc_guard, monkeypatch, tmp_path):
    import matplotlib

    from slam_process_tpu.render import fonts

    monkeypatch.setattr(fonts, "ASSET_FONT_DIR", tmp_path / "none")
    monkeypatch.delenv("SLAM_PROCESS_TPU_CJK_FONT", raising=False)
    default_minus = matplotlib.rcParams["axes.unicode_minus"]
    assert fonts.setup_cjk_font() is None
    assert matplotlib.rcParams["axes.unicode_minus"] == default_minus


def test_bundled_font_registers_and_renders(rc_guard, monkeypatch, tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from slam_process_tpu.render import fonts

    asset_dir = tmp_path / "fonts"
    asset_dir.mkdir()
    _synthesize_cjk_font(asset_dir / "synth_cjk.ttf")
    monkeypatch.setattr(fonts, "ASSET_FONT_DIR", asset_dir)

    family = fonts.setup_cjk_font()
    assert family == "SynthCJK"
    assert matplotlib.rcParams["font.sans-serif"][0] == "SynthCJK"
    assert matplotlib.rcParams["axes.unicode_minus"] is False

    # Render the reference title: no missing-glyph warnings allowed.
    fig, ax = plt.subplots()
    ax.set_title(PROBE_TEXT)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fig.canvas.draw()
    plt.close(fig)


def test_full_figure_uses_bundled_font(rc_guard, monkeypatch, tmp_path):
    """End-to-end: save_heatmap_figure picks the bundled font up."""
    from slam_process_tpu.render import fonts

    asset_dir = tmp_path / "fonts"
    asset_dir.mkdir()
    _synthesize_cjk_font(asset_dir / "synth_cjk.ttf")
    monkeypatch.setattr(fonts, "ASSET_FONT_DIR", asset_dir)

    from slam_process_tpu.render.figures import save_heatmap_figure

    mat = np.abs(np.random.default_rng(0).normal(size=(8, 8))) + 1.0
    out = tmp_path / "fig.png"
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        save_heatmap_figure(mat, np.arange(8.0), np.arange(8.0), out,
                            title=PROBE_TEXT)
    assert out.stat().st_size > 10_000
