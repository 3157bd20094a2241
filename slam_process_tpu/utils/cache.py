"""Persistent XLA compilation cache for every jitted path in the package.

The flagship device programs (the v1-7 NN-OMP estimator at the 0.1-degree
grid in particular) take tens of seconds to compile; a fresh process —
``cli estimate --engine device``, a user script, the benchmark — must not
pay that more than once per checkout.  Every jit factory in the package
calls :func:`enable_persistent_cache` before building its executable.

Where the cache lives:

1. ``JAX_COMPILATION_CACHE_DIR`` set (JAX reads it into
   ``jax_compilation_cache_dir``), or the caller configured the cache
   itself: that directory, exactly, and nothing is set here;
2. otherwise the fixed path ``<checkout>/build/jax_cache/<backend>-jax<ver>``
   — the path is part of JAX's cache key, so it must not move between runs.

CPU entries embed AOT-compiled host code; :func:`ensure_portable_cpu_isa`
caps XLA:CPU codegen at AVX2 so a copied checkout's CPU entries still
load on another x86-64 host.

Set ``SLAM_PROCESS_TPU_NO_COMPILE_CACHE=1`` to disable entirely.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

_DONE: Optional[str] = None

#: Base directory used when ``JAX_COMPILATION_CACHE_DIR`` is not set.
DEFAULT_BASE = Path(__file__).resolve().parents[2] / "build" / "jax_cache"

_PORTABLE_ISA = "AVX2"


def ensure_portable_cpu_isa() -> bool:
    """Cap XLA:CPU codegen at a portable ISA (AVX2) via ``XLA_FLAGS``.

    Must run BEFORE the CPU backend initializes.  Persistent-cache entries
    then load on any x86-64 host with AVX2, and the ``cpu_aot_loader``
    machine-feature mismatch warning does not fire (uncapped XLA appends
    tuning pseudo-features that the host-feature probe never reports).

    Returns True when the cap is (already) in effect; False when the
    caller set a different ``xla_cpu_max_isa`` explicitly (respected).
    """
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_cpu_max_isa" in flags:
        return f"xla_cpu_max_isa={_PORTABLE_ISA}" in flags
    os.environ["XLA_FLAGS"] = (
        f"{flags} --xla_cpu_max_isa={_PORTABLE_ISA}").strip()
    return True


def default_cache_dir(backend: str) -> Path:
    """Where the cache lives when ``JAX_COMPILATION_CACHE_DIR`` is unset:
    a subdirectory named from the backend and the JAX version only."""
    import jax

    return DEFAULT_BASE / f"{backend}-jax{jax.__version__}"


def _jax_config_dir() -> Optional[str]:
    """The cache directory JAX is already configured with, if any."""
    import jax

    return getattr(jax.config, "jax_compilation_cache_dir", None)


def enable_persistent_cache() -> Optional[str]:
    """Idempotently configure JAX's persistent compilation cache.

    Returns the cache directory in use (or None when disabled/unavailable).
    Cheap after the first call; safe to call from every jit factory.
    """
    global _DONE
    if _DONE is not None:
        return _DONE or None
    if os.environ.get("SLAM_PROCESS_TPU_NO_COMPILE_CACHE"):
        _DONE = ""
        return None
    try:
        import jax

        current = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
                   or _jax_config_dir())
        if current:
            _DONE = str(current)
            return _DONE
        # default_backend() initializes the backend; callers are jit
        # factories about to dispatch, so init is imminent regardless.
        path = default_cache_dir(jax.default_backend())
        path.mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(path))
        # Small programs recompile faster than a cache round-trip; only
        # persist compiles that actually hurt.
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
        _DONE = str(path)
        return _DONE
    except Exception:   # pragma: no cover — cache is an optimization only
        _DONE = ""
        return None
