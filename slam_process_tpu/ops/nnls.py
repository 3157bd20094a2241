"""Jittable non-negative least squares (Lawson-Hanson active set).

The reference refits NN-OMP atom coefficients with ``scipy.optimize.nnls``
every iteration (heatmap_gemini_v1-7.py:239).  scipy's implementation is
the classic Lawson-Hanson algorithm with data-dependent iteration count —
here it is reformulated with a bounded ``lax.while_loop`` over an active-set
bitmask so it jits (SURVEY.md hard part #3).  The problem sizes in this
engine are tiny (K <= 20 atoms over M = 4096 samples), so the solver works
on the Gram system G = A^T A, b = A^T y with [K, K] dense solves — the
M-dimensional work is two matmuls outside the loop, and the loop body
is O(K^2) scalar-ish elementwise work.

The masked subproblem solve uses the identity-padding trick: rows/cols
outside the passive set P are replaced by identity so the solution is
exactly zero there, keeping shapes static.
"""

from __future__ import annotations

import functools
from typing import Tuple


def nnls_gram(G, b, max_outer: int = 64, max_inner: int = 16,
              tol: float = 1e-10, tol_rel: float = 3e-7,
              solver: str = "auto", x0=None, P0=None):
    """Solve min ||A x - y||, x >= 0 given G = A^T A and b = A^T y.

    Returns (x, passive_mask).  ``max_outer`` bounds active-set additions
    (>= K suffices for exact termination in exact arithmetic).

    ``solver`` picks the masked subproblem solve: "auto" = closed-form
    adjugate at K=3, Gauss-Jordan fori_loop for K>3; "lu" forces
    ``jnp.linalg.solve`` (kept for A/B comparison).

    ``x0``/``P0`` warm-start the active set: pass the previous solution
    when G/b grew by one atom (the OMP refit pattern — old rows/cols of
    the Gram and old b entries are unchanged, so x0 is still optimal on
    P0 and Lawson-Hanson resumes instead of re-adding every atom from
    scratch).  The NNLS optimum is unique (G SPD on the atom span), so
    warm and cold starts converge to the same x up to f32 rounding —
    the same robustness class as the LU/GJ/adjugate solver swaps, gated
    by the same selection-sequence parity tests.  Invariant required:
    x0 >= 0, x0 zero outside P0, and x0 optimal for the subproblem
    restricted to P0 (all hold for a previous nnls_gram result).

    The convergence tolerance is ``tol + tol_rel * max|b|``: a purely
    absolute 1e-10 is float64 thinking — in float32 the gradient
    ``w = b - G x`` at the optimum carries rounding noise proportional to
    |b| (~1e-7 relative), so the while_loop would spin to max_outer on
    every instance, never passing the test.  Measured on the chip this
    inflated the vmapped estimator ~8x (the loop runs in lockstep across
    all vmap lanes, so ONE non-converging lane taxes everyone).
    """
    import jax
    import jax.numpy as jnp

    k = G.shape[0]
    # Relative tolerance for the gradient test only; the coefficient tests
    # (z <= tol) keep the absolute threshold — coefficients live on a
    # different scale than b and treating small positives as negative would
    # change which atoms survive.
    w_tol = tol + tol_rel * jnp.max(jnp.abs(b))

    def solve_passive(P):
        # Rows/cols outside P are replaced by identity -> exact zeros there.
        Pf = P.astype(G.dtype)
        Gp = G * (Pf[:, None] * Pf[None, :]) + jnp.diag(1.0 - Pf)
        bp = b * Pf
        if k > 3 and solver != "lu":
            # Gauss-Jordan elimination without pivoting, as one fori_loop
            # over an augmented [K, K+1] tile.  Gp is SPD on the passive
            # set and identity on its complement (diagonal >= 1 there), so
            # pivoting is unnecessary; ``jnp.linalg.solve``'s general LU
            # lowers to hundreds of tiny serialized ops (row-pivot argmax +
            # swaps per column + two triangular solves) and this solve sits
            # inside BOTH nested NNLS while-loops of the K=20 session
            # estimator.  GJ is K steps of pure elementwise work on one
            # small tile.  A zero pivot (degenerate
            # passive Gram from near-collinear atoms) zeroes that row's
            # contribution instead of laundering inf/NaN — same guard
            # policy as the k==3 adjugate branch below.
            import jax as _jax

            aug = jnp.concatenate([Gp, bp[:, None]], axis=1)   # [K, K+1]

            def gj_step(i, m):
                piv = m[i, i]
                inv_piv = jnp.where(jnp.abs(piv) > 1e-30, 1.0 / piv, 0.0)
                row = m[i] * inv_piv
                col = m[:, i]
                m2 = m - col[:, None] * row[None, :]
                return m2.at[i].set(row)

            aug = _jax.lax.fori_loop(0, k, gj_step, aug)
            return aug[:, k]
        if k == 3:
            # Closed-form adjugate solve: jnp.linalg.solve's batched LU is
            # dozens of tiny ops per while-loop iteration, and this solve
            # sits inside BOTH nested NNLS loops of the per-sweep hot
            # path.  A 3x3 Gram
            # (identity-completed, SPD on the passive set) is far from the
            # conditioning regime where LU pivoting beats Cramer in f32;
            # coefficient parity vs the float64 oracle is asserted by the
            # same selection-sequence/rtol tests as always.
            (a11, a12, a13), (a21, a22, a23), (a31, a32, a33) = (
                Gp[0], Gp[1], Gp[2])
            c11 = a22 * a33 - a23 * a32
            c12 = a13 * a32 - a12 * a33
            c13 = a12 * a23 - a13 * a22
            c21 = a23 * a31 - a21 * a33
            c22 = a11 * a33 - a13 * a31
            c23 = a13 * a21 - a11 * a23
            c31 = a21 * a32 - a22 * a31
            c32 = a12 * a31 - a11 * a32
            c33 = a11 * a22 - a12 * a21
            det = a11 * c11 + a12 * c21 + a13 * c31
            # Degenerate-Gram guard: near-collinear selected atoms can
            # underflow det to 0 in f32, and 1/0 would launder inf/NaN
            # through max_coeff and the keep rules.  Returning zeros
            # instead makes the inner loop drop the offending atoms (the
            # same outcome a pivoted solve's huge coefficients feed into
            # the anti-cycling step, minus the NaNs).
            inv_det = jnp.where(jnp.abs(det) > 1e-30, 1.0 / det, 0.0)
            return jnp.stack([
                (c11 * bp[0] + c12 * bp[1] + c13 * bp[2]) * inv_det,
                (c21 * bp[0] + c22 * bp[1] + c23 * bp[2]) * inv_det,
                (c31 * bp[0] + c32 * bp[1] + c33 * bp[2]) * inv_det,
            ])
        return jnp.linalg.solve(Gp, bp)

    def outer_cond(state):
        x, P, it, done = state
        return (~done) & (it < max_outer)

    def outer_body(state):
        x, P, it, _ = state
        w = b - G @ x
        w_masked = jnp.where(P, -jnp.inf, w)
        j = jnp.argmax(w_masked)
        can_add = (w_masked[j] > w_tol) & (~jnp.all(P))
        P_new = P.at[j].set(True)

        def inner_body(carry):
            x_c, P_c, inner_it, inner_done = carry
            z = solve_passive(P_c)
            neg = P_c & (z <= tol)
            any_neg = jnp.any(neg)

            def fix(_):
                alpha_cands = jnp.where(neg, x_c / jnp.maximum(x_c - z, 1e-300), jnp.inf)
                alpha = jnp.min(alpha_cands)
                x_n = x_c + alpha * (z - x_c)
                P_n = P_c & (x_n > tol)
                return x_n, P_n, inner_it + 1, False

            def accept(_):
                return z, P_c, inner_it + 1, True

            return jax.lax.cond(any_neg, fix, accept, None)

        def inner_cond(carry):
            _, _, inner_it, inner_done = carry
            return (~inner_done) & (inner_it < max_inner)

        x_upd, P_upd, _, _ = jax.lax.while_loop(
            inner_cond, inner_body, (x, P_new, 0, False)
        )
        x_out = jnp.where(can_add, jnp.maximum(x_upd, 0.0), x)
        P_out = jnp.where(can_add, P_upd, P)
        return x_out, P_out, it + 1, ~can_add

    if x0 is None:
        x0 = jnp.zeros(k, dtype=G.dtype)
    if P0 is None:
        P0 = jnp.zeros(k, dtype=bool)
    x, P, _, _ = jax.lax.while_loop(outer_cond, outer_body, (x0, P0, 0, False))
    return x, P


def nnls(A, y, max_outer: int = 64) -> Tuple:
    """min ||A x - y||, x >= 0 for a dense [M, K] design matrix (jittable)."""
    import jax.numpy as jnp

    G = A.T @ A
    b = A.T @ y
    return nnls_gram(G, b, max_outer=max_outer)


@functools.lru_cache(maxsize=4)
def jitted_nnls():
    import jax

    from slam_process_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    from slam_process_tpu.utils.precision import jit_highest

    return jit_highest(nnls)
