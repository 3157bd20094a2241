"""CJK font discovery/registration for figure chrome.

The reference sets ``plt.rcParams['font.sans-serif'] = ['SimHei', ...]``
and ``axes.unicode_minus = False`` at import (excel_heatmap.py:19-30); its
golden renders were made with Windows SimHei.  This module reproduces that
setup with whatever CJK-capable font is available:

  1. any font file bundled under ``slam_process_tpu/assets/fonts/``
     (drop a Noto Sans SC / SimHei .ttf/.otf there and every figure picks
     it up — nothing else to configure);
  2. the ``SLAM_PROCESS_TPU_CJK_FONT`` environment variable (a font file
     path);
  3. CJK families already known to matplotlib (SimHei, Noto Sans CJK SC,
     WenQuanYi, Microsoft YaHei, Source Han Sans SC).

When none is found (no CJK font is installed), figures fall back
gracefully: DejaVu renders the Latin chrome, CJK labels show as boxes, and the golden tests
use shift-tolerant structural checks for those figures.  Note that exact
pixel parity with the reference's text would require SimHei itself; any
substitute (including Noto) changes glyph rasters.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path
from typing import Optional

ASSET_FONT_DIR = Path(__file__).resolve().parent.parent / "assets" / "fonts"
_CJK_FAMILIES = (
    "SimHei",
    "Noto Sans CJK SC",
    "Noto Sans SC",
    "Source Han Sans SC",
    "WenQuanYi Zen Hei",
    "Microsoft YaHei",
)
# A character from the reference figure titles, used as the coverage probe.
_PROBE_CHAR = 0x6CE2   # 波 (as in 波束对平均RSSI热力图)


def _has_cjk(font_path: str) -> bool:
    try:
        from fontTools.ttLib import TTFont

        cmap = TTFont(font_path, fontNumber=0).getBestCmap()
        return _PROBE_CHAR in cmap
    except Exception:
        return False


@functools.lru_cache(maxsize=1)
def setup_cjk_font() -> Optional[str]:
    """Register a CJK font with matplotlib and set the reference rcParams.

    Returns the registered family name, or None when no CJK font exists.
    ``axes.unicode_minus=False`` is applied only when a CJK font is found
    (the reference couples it to its SimHei setup); the no-font fallback
    keeps matplotlib-default tick glyphs so the pic/ goldens still match.
    """
    import matplotlib
    import matplotlib.font_manager as fm

    candidates = []
    if ASSET_FONT_DIR.is_dir():
        for ext in ("*.ttf", "*.otf", "*.ttc"):
            candidates += sorted(ASSET_FONT_DIR.glob(ext))
    env = os.environ.get("SLAM_PROCESS_TPU_CJK_FONT")
    if env:
        candidates.append(Path(env))

    def _activate(family):
        # The reference couples unicode_minus=False to its SimHei setup
        # (excel_heatmap.py:19-30); apply it only when a CJK font exists so
        # the no-font fallback keeps matplotlib-default tick glyphs (the
        # pic/ goldens were made with those).
        matplotlib.rcParams["axes.unicode_minus"] = False
        matplotlib.rcParams["font.sans-serif"] = [
            family] + list(matplotlib.rcParams["font.sans-serif"])
        return family

    for path in candidates:
        if path.is_file() and _has_cjk(str(path)):
            fm.fontManager.addfont(str(path))
            return _activate(fm.FontProperties(fname=str(path)).get_name())

    installed = {f.name: f.fname for f in fm.fontManager.ttflist}
    for family in _CJK_FAMILIES:
        fname = installed.get(family)
        if fname and _has_cjk(fname):
            return _activate(family)
    return None
