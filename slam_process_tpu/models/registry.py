"""Estimator registry: one entry point for every model family.

Each estimator mirrors one reference experiment (SURVEY.md sections 2.4 /
2.5).  ``run_estimator(name, session, ...)`` assembles the scene, runs the
model, classifies, renders, and returns a pandas DataFrame of paths in the
reference's output format (AoA, AoD, Power, PathType).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np

from slam_process_tpu.config import (
    ClassifierConfig,
    DictionaryConfig,
    OmpConfig,
    SceneConfig,
)
from slam_process_tpu.io.angles import load_angle_lut
from slam_process_tpu.models.classifiers import (
    LABEL_NAMES,
    ClassifiedPaths,
    classify_advanced,
    classify_argmax,
)
from slam_process_tpu.models.dictionary import make_dictionary
from slam_process_tpu.models.nn_omp import run_nn_omp
from slam_process_tpu.ops.scene import compact_grid, fill_grid, intensity_grid_np
from slam_process_tpu.render.estimation import estimation_plot


def build_scene(session, angle_file, log_transform: bool):
    """Filtered frames -> (matrix[U, B], ue_angles, bs_angles)."""
    if session.filtered is None:
        session.correct()
    ue, bs, rss = (session.filtered[:, i] for i in range(3))
    cfg = SceneConfig(log_transform=log_transform)
    grid = intensity_grid_np(ue, bs, rss, cfg=cfg)
    filled = fill_grid(grid, cfg)
    lut = load_angle_lut(angle_file)
    matrix, ue_ang, bs_ang, _, _ = compact_grid(grid, filled, lut)
    return matrix, ue_ang, bs_ang


def paths_dataframe(c: ClassifiedPaths) -> "pd.DataFrame":
    import pandas as pd

    keep = np.asarray(c.valid)
    return pd.DataFrame(
        {
            "AoA": np.asarray(c.aoa)[keep],
            "AoD": np.asarray(c.aod)[keep],
            "Power": np.asarray(c.power)[keep],
            "PathType": [LABEL_NAMES[int(l)] for l in np.asarray(c.label)[keep]],
        }
    )


def _estimate_nn_omp(session, angle_file, output_path, *, flavor: str,
                     **overrides):
    if flavor == "v1-7":
        dict_cfg = DictionaryConfig(
            grid_res=overrides.get("grid_res", 0.1),
            beam_width=overrides.get("beam_width", 1.4),
            grid_kind="linspace",
        )
        omp_cfg = OmpConfig(
            max_paths=overrides.get("max_paths", 20),
            min_power_ratio=overrides.get("min_power_ratio", 0.0003),
        )
        log_transform, keep_rule, stop_np = True, "ratio", True
        style = "v1-7"
    else:  # v1 — the golden pic/ configuration
        dict_cfg = DictionaryConfig(
            grid_res=overrides.get("grid_res", 0.1),
            beam_width=overrides.get("beam_width", 1.4),
            grid_kind="arange",
        )
        omp_cfg = OmpConfig(max_paths=overrides.get("max_paths", 3))
        log_transform, keep_rule, stop_np = False, "positive", False
        style = "v1"

    matrix, ue_ang, bs_ang = build_scene(session, angle_file, log_transform)
    dictionary = make_dictionary(ue_ang, bs_ang, dict_cfg)
    paths = run_nn_omp(dictionary, matrix, omp_cfg, keep_rule=keep_rule,
                       stop_nonpositive=stop_np,
                       engine=overrides.get("engine", "host"))

    if flavor == "v1-7":
        cls_cfg = ClassifierConfig(
            sidelobe_width_aoa=overrides.get("sidelobe_width_aoa", 5.0),
            sidelobe_width_aod=overrides.get("sidelobe_width_aod", 5.0),
            nlos_power_thresh_db=overrides.get("nlos_power_thresh_db", 0.01),
            nlos_angle_separation=overrides.get("nlos_angle_separation", 15.0),
            sidelobe_power_ratio_db=overrides.get("sidelobe_power_ratio_db", 0.15),
        )
        classified = classify_advanced(paths.aoa, paths.aod, paths.power,
                                       paths.valid, cls_cfg)
    else:
        classified = classify_argmax(paths.aoa, paths.aod, paths.power,
                                     paths.valid)

    if output_path is not None:
        estimation_plot(matrix, ue_ang, bs_ang, classified, output_path,
                        style=style)
    return paths_dataframe(classified)


_REGISTRY = {}


def register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


@register("nn_omp")
def _nn_omp_v17(session, angle_file, output_path=None, **overrides):
    """Flagship: v1-7 NN-OMP with log pre-transform + advanced classifier."""
    return _estimate_nn_omp(session, angle_file, output_path, flavor="v1-7",
                            **overrides)


@register("nn_omp_v1")
def _nn_omp_v1(session, angle_file, output_path=None, **overrides):
    """Original v1 NN-OMP (source of the golden pic/ renders)."""
    return _estimate_nn_omp(session, angle_file, output_path, flavor="v1",
                            **overrides)


def _estimate_with_classifier(session, angle_file, output_path, classify,
                              max_paths=10, **overrides):
    """Shared core for the v1-4/v1-5/v1-6 revisions: v1 scene + linspace
    dictionary + NN-OMP with the power-ratio keep rule, then the given
    classifier (SURVEY.md section 2.4 revision deltas)."""
    dict_cfg = DictionaryConfig(
        grid_res=overrides.get("grid_res", 0.1),
        beam_width=overrides.get("beam_width", 1.4),
        grid_kind="linspace",
    )
    omp_cfg = OmpConfig(
        max_paths=overrides.get("max_paths", max_paths),
        min_power_ratio=overrides.get("min_power_ratio", 0.01),
    )
    matrix, ue_ang, bs_ang = build_scene(session, angle_file,
                                         log_transform=False)
    dictionary = make_dictionary(ue_ang, bs_ang, dict_cfg)
    paths = run_nn_omp(dictionary, matrix, omp_cfg,
                       engine=overrides.get("engine", "host"))
    classified = classify(paths)
    if output_path is not None:
        estimation_plot(matrix, ue_ang, bs_ang, classified, output_path,
                        style="v1-7")
    return paths_dataframe(classified)


@register("nn_omp_v14")
def _nn_omp_v14(session, angle_file, output_path=None, **overrides):
    """v1-4: robust linspace grids + inline weak-and-far classifier."""
    from slam_process_tpu.models.classifiers import classify_weak_far

    return _estimate_with_classifier(
        session, angle_file, output_path,
        lambda p: classify_weak_far(p.aoa, p.aod, p.power, p.valid),
        **overrides,
    )


@register("nn_omp_v15")
def _nn_omp_v15(session, angle_file, output_path=None, **overrides):
    """v1-5: cross-region PathClassifier (sidelobes before NLoS)."""
    from slam_process_tpu.models.classifiers import classify_cross_region

    return _estimate_with_classifier(
        session, angle_file, output_path,
        lambda p: classify_cross_region(
            p.aoa, p.aod, p.power, p.valid,
            sidelobe_width_aoa=overrides.get("sidelobe_width_aoa", 45.0),
            sidelobe_width_aod=overrides.get("sidelobe_width_aod", 45.0),
            nlos_power_thresh_db=overrides.get("nlos_power_thresh_db", 10.0),
            nlos_min_angle_sep=overrides.get("nlos_min_angle_sep", 20.0),
        ),
        **overrides,
    )


@register("nn_omp_v16")
def _nn_omp_v16(session, angle_file, output_path=None, **overrides):
    """v1-6: AdvancedPathClassifier without the v1-7 log pre-transform."""
    return _estimate_with_classifier(
        session, angle_file, output_path,
        lambda p: classify_advanced(p.aoa, p.aod, p.power, p.valid,
                                    ClassifierConfig()),
        **overrides,
    )


def run_estimator(
    name: str,
    session,
    angle_file: Union[str, Path],
    output_path: Optional[Union[str, Path]] = None,
    **overrides,
) -> "pd.DataFrame":
    if name not in _REGISTRY:
        raise KeyError(f"unknown estimator {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](session, angle_file, output_path, **overrides)


# Late imports register the remaining model families (kept in separate
# modules).  A broken module must fail loudly — silently dropping an
# estimator from the registry would surface as a confusing KeyError at
# run_estimator time instead of the real import failure.
def _register_extended():
    import importlib
    import logging

    failures = []
    for mod in (
        "sm_sic",
        "svd_est",
        "lasso_refine",
        "peak_picking",
        "fusion",
        "omp_dense",
        "geometric",
        "nn_omp_v13",
    ):
        try:
            importlib.import_module(f"slam_process_tpu.models.{mod}")
        except Exception as e:  # pragma: no cover - exercised via unit test
            logging.getLogger(__name__).error(
                "estimator module %s failed to import: %s", mod, e
            )
            failures.append((mod, e))
    if failures:
        names = ", ".join(m for m, _ in failures)
        raise ImportError(
            f"estimator modules failed to register: {names}"
        ) from failures[0][1]


_register_extended()
