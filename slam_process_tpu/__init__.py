"""slam_process_tpu — accelerator-native mmWave beam-scan SLAM processing engine.

A brand-new JAX / XLA / Pallas framework with the capabilities of the
``lull21/slam-process`` reference pipeline (a set of CPU pandas/matplotlib
scripts).  The engine holds a scan session as device-resident tensors

    bytes[u8, N]  ->  frames[F, 5] i32 (flag, ue, bs, rss, clk)
    -> corrected frames -> intensity[64, 64] f32 (+ masks)
    -> paths[P, 4] + rgba[H, W, 4] u8

and runs decode / correct / scene-assembly / multipath-estimation / raster
as jitted stages, ``vmap``-ed over sweeps and ``shard_map``-ed over device
meshes for whole-session batches.

Layer map (mirrors SURVEY.md section 1):
    io/        L0/L1 host I/O: hex logs, xlsx tables, beam-angle map
    ops/       device kernels: decode, correct, scene, blur, raster, interp,
               nnls, lasso, peaks
    models/    L4/L5 multipath estimators + path classifiers
    render/    L6 heatmap rasters + matplotlib figure shim
    parallel/  mesh construction, batched/sharded session pipelines, streaming
    pipeline/  L7 typed config, stage orchestration, CLI drivers
    utils/     logging/counters, timestamp parsing, profiling hooks
"""

__version__ = "0.1.0"

from slam_process_tpu.config import (  # noqa: F401
    CorrectConfig,
    DictionaryConfig,
    ClassifierConfig,
    RenderConfig,
    SceneConfig,
)


def __getattr__(name):
    # Lazy top-level conveniences (avoid importing jax/matplotlib at
    # package import time).
    if name == "Session":
        from slam_process_tpu.pipeline.session import Session

        return Session
    if name == "run_estimator":
        from slam_process_tpu.models import run_estimator

        return run_estimator
    raise AttributeError(name)
