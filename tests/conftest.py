"""Test configuration: the CPU lane, the GPU lane, and the generated archive.

Two lanes, chosen by one environment variable that every xdist worker
reads the same way:

* CPU lane (default): force the CPU backend with 8 virtual devices, so
  sharding is tested on a virtual mesh.  Runs everything; tests marked
  ``gpu`` skip inside their fixture.
* GPU lane (``SLAM_PROCESS_TPU_TEST_GPU=1 python -m pytest tests -m gpu``
  on a machine with the card): keeps JAX's default backend.

Inputs come from ``slam_process_tpu.io.synth``: a small archive of seeded
captures written once into ``tests/_cache/`` with the reference archive's
file names, its parsed/filtered ``.xlsx`` tables and a beam-angle mapping.
The parsed table is the generator's planted frame table (independent of the
decoder); the filtered table is the float64 host corrector's output.
"""

import os
import shutil
import sys
from pathlib import Path

GPU_LANE = os.environ.get("SLAM_PROCESS_TPU_TEST_GPU") == "1"

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

if not GPU_LANE:
    os.environ["JAX_PLATFORMS"] = "cpu"
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    from slam_process_tpu.utils.cache import ensure_portable_cpu_isa

    ensure_portable_cpu_isa()

import jax  # noqa: E402

if not GPU_LANE:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

CACHE = REPO_ROOT / "tests" / "_cache"

#: The generated fixture archive: (log file name, frames, sweeps, seed).
#: Names follow the reference archive's; the first two have its sizes.
ARCHIVE_VERSION = 3
ARCHIVE_LOGS = (
    ("256-0x16-Serial Debug 2026-01-26 164520.txt", 18630, 8, 11),
    ("Serial Debug 2026-02-06 091211.txt", 28313, 10, 17),
    ("Serial Debug 2026-02-06 091351.txt", 21000, 8, 13),
    ("Serial Debug 2026-02-06 091535.txt", 24000, 9, 14),
)
LOG_NAMES = tuple(name for name, *_ in ARCHIVE_LOGS)
DEBUGDOC = CACHE / f"archive-v{ARCHIVE_VERSION}"

# A small session (18.6k frames) used for fast tests.
SMALL_LOG = DEBUGDOC / "256-0x16-Serial Debug 2026-01-26 164520.txt"
SMALL_PARSED = DEBUGDOC / "Serial Debug 2026-01-26 164520.xlsx"
SMALL_FILTERED = DEBUGDOC / "Serial Debug 2026-01-26 164520_filtered.xlsx"
SMALL_LOG_2026_02_06 = DEBUGDOC / "Serial Debug 2026-02-06 091211.txt"
PARSED_2026_02_06 = DEBUGDOC / "Serial Debug 2026-02-06 091211.xlsx"
FILTERED_2026_02_06 = DEBUGDOC / "Serial Debug 2026-02-06 091211_filtered.xlsx"
BEAM_ANGLE = DEBUGDOC / "beam_angle.xlsx"

#: The reference repository's scripts and golden PNGs (optional).
_REF_ENV = os.environ.get("SLAM_PROCESS_REFERENCE")
REFERENCE = Path(_REF_ENV) if _REF_ENV else None


def _stem(log_name: str) -> str:
    return log_name.split("Serial Debug ", 1)[1][:-4]


def _write_archive(directory: Path) -> None:
    from slam_process_tpu.io import synth
    from slam_process_tpu.io.angles import write_angle_map
    from slam_process_tpu.io.schemas import (
        write_filtered_table,
        write_parsed_table,
    )
    from slam_process_tpu.ops.correct import correct_frames_np

    directory.mkdir(parents=True)
    for name, n_frames, n_sweeps, seed in ARCHIVE_LOGS:
        cap = synth.capture(seed, n_frames, n_sweeps, name=name)
        synth.write_capture(directory, cap)
        stem = f"Serial Debug {_stem(name)}"
        write_parsed_table(directory / f"{stem}.xlsx", cap.frames)
        write_filtered_table(directory / f"{stem}_filtered.xlsx",
                             correct_frames_np(cap.frames).filtered)
    write_angle_map(directory / "beam_angle.xlsx")


def _ensure_archive() -> None:
    """Write the fixture archive once; concurrent workers race safely."""
    if DEBUGDOC.exists():
        return
    tmp = CACHE / f".archive-tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    _write_archive(tmp)
    try:
        os.rename(tmp, DEBUGDOC)
    except OSError:            # another worker got there first
        shutil.rmtree(tmp, ignore_errors=True)


_ensure_archive()


def _cached(name: str, builder):
    """Parse-once cache for golden tables (xlsx parsing is the slow part)."""
    path = DEBUGDOC / f"{name}.npz"
    if path.exists():
        with np.load(path) as z:
            return z["data"]
    data = builder()
    tmp = DEBUGDOC / f".{name}-{os.getpid()}.npz"
    np.savez_compressed(tmp, data=data)
    os.replace(tmp, path)
    return data


@pytest.fixture
def require_gpu():
    """Skip unless JAX's default backend is the GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU backend "
                    "(SLAM_PROCESS_TPU_TEST_GPU=1 python -m pytest tests -m gpu)")


@pytest.fixture
def require_reference():
    """Skip unless the reference repository's scripts and goldens exist."""
    if REFERENCE is None or not REFERENCE.is_dir():
        pytest.skip("needs the reference repository's scripts or golden "
                    "images (set SLAM_PROCESS_REFERENCE to its checkout)")
    return REFERENCE


@pytest.fixture(scope="session")
def small_log_bytes():
    from slam_process_tpu.io import read_hex_log

    return read_hex_log(SMALL_LOG, engine="numpy")


@pytest.fixture(scope="session")
def small_parsed_golden():
    from slam_process_tpu.io.schemas import read_parsed_table

    return _cached("parsed_164520", lambda: read_parsed_table(SMALL_PARSED))


@pytest.fixture(scope="session")
def small_filtered_golden():
    from slam_process_tpu.io.schemas import read_filtered_table

    return _cached("filtered_164520", lambda: read_filtered_table(SMALL_FILTERED))


@pytest.fixture(scope="session")
def parsed_golden_020606():
    from slam_process_tpu.io.schemas import read_parsed_table

    return _cached("parsed_091211", lambda: read_parsed_table(PARSED_2026_02_06))


@pytest.fixture(scope="session")
def filtered_golden_020606():
    from slam_process_tpu.io.schemas import read_filtered_table

    return _cached("filtered_091211", lambda: read_filtered_table(FILTERED_2026_02_06))


@pytest.fixture(scope="session")
def angle_lut64():
    from slam_process_tpu.io.angles import load_angle_lut

    return load_angle_lut(BEAM_ANGLE)


def load_reference_module(name: str, path: str):
    """Import a reference script as a module for use as a live test oracle.

    ``path`` is relative to the reference checkout (tests reach this only
    through the ``require_reference`` fixture).  Several reference scripts
    mutate global matplotlib rcParams at import time (e.g.
    heatmap_gemini_v1-7.py:13-14 sets font.sans-serif and
    axes.unicode_minus), which would silently change every later render in
    the test session — snapshot and restore around the import.
    """
    import importlib.util

    import matplotlib

    saved = matplotlib.rcParams.copy()
    try:
        spec = importlib.util.spec_from_file_location(name, REFERENCE / path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    finally:
        dict.update(matplotlib.rcParams, saved)
