"""Matmul-precision pinning for value-carrying contractions.

Accelerators run float32 matmuls at reduced precision by default: bf16
inputs (~8 mantissa bits) on some, TF32 (~10 bits) on the H100's tensor
cores.  For FLOP-bound neural workloads that is the right default; for
this pipeline's
*value-carrying* contractions it is not: the estimators' correlation chains
(``phi_rx.T @ residual @ phi_tx``) feed an argmax whose winner can flip
between near-tied atoms at 0.4% error, changing the selected path set — the
same failure mode as the blur's LUT-bin flips under bf16: the flagship
v1-7 NN-OMP was seen to select a different FIRST atom under bf16 than the
float64 oracle.

:func:`jit_highest` is ``jax.jit`` with ``default_matmul_precision`` pinned
to HIGHEST for everything traced inside — use it for every estimator /
scene-value program.  Throughput note: on the H100, HIGHEST runs float32
outside the tensor cores (ROADMAP A4 weighs 3-pass bf16 algorithms); the
selection sequence against the float64 oracle stays the bar.
"""

from __future__ import annotations

import functools


def jit_highest(fn, **jit_kwargs):
    """``jax.jit(fn)`` with matmul precision pinned to HIGHEST at trace time."""
    import jax

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return jax.jit(wrapped, **jit_kwargs)
