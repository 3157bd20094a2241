"""Beam-ID -> physical-angle mapping.

The testbed's 64 beams map to angles -43.6 deg .. +45.0 deg (~1.4 deg pitch)
via ``beam_angle.xlsx`` (Sheet1, columns BeamID/Angle).  The reference loads
this table five different ways (excel_heatmap.py:173-244 by-name,
heatmap_gemini_v1.py:35-44 first-two-columns, heatmap_gemini_v3.py:23-43
headerless-tolerant, heatmap_gpt_v2.py:21-30 heuristic, gpt_v1.py:9-14
itertuples).  This is the single tolerant loader; the device-side artifact
is a dense float32 LUT of length ``n_beams`` (NaN = unmapped) so the
beam->angle remap is a pure gather on device.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Union

import numpy as np

from slam_process_tpu.io.xlsx import read_xlsx_table, write_xlsx_table

#: Built-in 64-beam table: -43.6 .. +45.0 deg at ~1.4 deg pitch.  The end
#: points and pitch are the testbed's (SURVEY §2.8); the exact values in
#: between are ASSUMED (linear, rounded to 0.1 deg), so generated captures
#: and the reference's ``beam_angle.xlsx`` can differ by up to 0.1 deg.
BEAM_ANGLES_DEG = np.round(np.linspace(-43.6, 45.0, 64), 1).astype(np.float32)


def write_angle_map(path: Union[str, Path],
                    angles: np.ndarray = BEAM_ANGLES_DEG) -> Path:
    """Write a BeamID/Angle mapping ``.xlsx`` that ``load_angle_lut`` reads."""
    table = np.stack([np.arange(len(angles)), np.asarray(angles, np.float64)],
                     axis=1)
    return write_xlsx_table(path, ["BeamID", "Angle"], table)


def load_angle_map(path: Union[str, Path]) -> Dict[int, float]:
    """Load BeamID -> angle(deg) as a dict, with/without header row."""
    names, data = read_xlsx_table(path, header=False)
    if data.shape[1] < 2:
        raise ValueError(f"angle map needs >=2 columns, got {data.shape[1]}")
    mapping: Dict[int, float] = {}
    for bid, ang in data[:, :2]:
        if np.isnan(bid) or np.isnan(ang):
            continue  # header row or junk parses as NaN
        mapping[int(round(bid))] = float(ang)
    if not mapping:
        raise ValueError(f"no numeric (BeamID, Angle) rows in {path}")
    return mapping


def angle_lut(mapping: Dict[int, float], n_beams: int = 64) -> np.ndarray:
    """Dense float32 LUT: lut[beam_id] = angle, NaN where unmapped."""
    lut = np.full(n_beams, np.nan, dtype=np.float32)
    for bid, ang in mapping.items():
        if 0 <= bid < n_beams:
            lut[bid] = ang
    return lut


def load_angle_lut(path: Union[str, Path], n_beams: int = 64) -> np.ndarray:
    return angle_lut(load_angle_map(path), n_beams)
