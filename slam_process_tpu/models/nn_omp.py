"""Non-negative orthogonal matching pursuit (the flagship estimator).

Reference: heatmap_gemini_v1.py:168-221 (original, max_paths=3, keep
coeff>0) and v1-7.py:200-268 (terminal revision: stop on non-positive
correlation or duplicate atom, keep coeff > max_coeff*min_power_ratio).

Per iteration: correlation via the Kronecker identity
``Phi_RX^T @ residual_matrix @ Phi_TX`` (two matmuls over the
[~887 x 64 x 64 x ~887] chain), grid argmax, atom refit with NNLS over the
selected outer-product atoms, residual update.  The jittable path keeps a
static max_paths-slot atom table and a done flag; the numpy path is the
float64 oracle with reference-exact control flow.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from slam_process_tpu.config import OmpConfig
from slam_process_tpu.models.dictionary import BeamDictionary


class OmpPaths(NamedTuple):
    """Estimated paths (fixed max_paths slots + validity mask)."""

    aoa: np.ndarray       # [K] grid angle per path
    aod: np.ndarray       # [K]
    power: np.ndarray     # [K] NNLS coefficient
    valid: np.ndarray     # [K] bool — kept by the power-ratio filter
    n_iters: int          # iterations actually executed
    aoa_idx: np.ndarray   # [K] grid indices (for parity checks)
    aod_idx: np.ndarray


def nn_omp_np(
    dictionary: BeamDictionary,
    rss_matrix: np.ndarray,
    cfg: OmpConfig = OmpConfig(),
    keep_rule: str = "ratio",   # "ratio" (v1-7) | "positive" (v1)
    stop_nonpositive: bool = True,  # v1-7 stops when max corr <= 0; v1 doesn't
    logger=None,
) -> OmpPaths:
    """Float64 host oracle with reference-exact control flow.

    ``logger`` (optional) receives the reference's per-iteration health
    counters: selected atom angles, coefficient, residual norm
    (heatmap_gemini_v1-7.py:247-249).
    """
    from scipy.optimize import nnls as scipy_nnls

    phi_rx, phi_tx = dictionary.phi_rx, dictionary.phi_tx
    y = rss_matrix.astype(np.float64).ravel()
    shape = rss_matrix.shape
    residual = y.copy()
    selected: list[tuple[int, int]] = []
    coeffs = np.zeros(0)
    it = 0
    for k in range(cfg.max_paths):
        corr = phi_rx.T @ residual.reshape(shape) @ phi_tx
        if stop_nonpositive and np.max(corr) <= 0:
            break
        i_r, i_t = np.unravel_index(np.argmax(corr), corr.shape)
        if (i_r, i_t) in selected:
            break
        selected.append((int(i_r), int(i_t)))
        A = np.column_stack(
            [np.outer(phi_rx[:, r], phi_tx[:, t]).ravel() for r, t in selected]
        )
        coeffs, _ = scipy_nnls(A, y)
        residual = y - A @ coeffs
        it = k + 1
        if logger is not None:
            logger.debug(
                "iter %d: AoA=%.1f AoD=%.1f coeff=%.4f residual=%.4f",
                k, dictionary.aoa_grid[i_r], dictionary.aod_grid[i_t],
                coeffs[-1], float(np.linalg.norm(residual)),
            )

    K = cfg.max_paths
    aoa = np.zeros(K)
    aod = np.zeros(K)
    power = np.zeros(K)
    valid = np.zeros(K, dtype=bool)
    aoa_idx = np.full(K, -1, dtype=np.int64)
    aod_idx = np.full(K, -1, dtype=np.int64)
    if len(coeffs):
        max_coeff = coeffs.max()
        for j, (r, t) in enumerate(selected):
            aoa[j] = dictionary.aoa_grid[r]
            aod[j] = dictionary.aod_grid[t]
            power[j] = coeffs[j]
            aoa_idx[j] = r
            aod_idx[j] = t
            if keep_rule == "ratio":
                valid[j] = coeffs[j] > max_coeff * cfg.min_power_ratio
            else:
                valid[j] = coeffs[j] > 0
    return OmpPaths(aoa, aod, power, valid, it, aoa_idx, aod_idx)


import functools as _functools


@_functools.lru_cache(maxsize=32)
def _jitted_nn_omp(cfg: OmpConfig, keep_rule: str, stop_nonpositive: bool):
    """Compiled NN-OMP shared across calls (configs are frozen/hashable).

    Forces the LU NNLS subproblem solve: unbatched, each of the
    Gauss-Jordan loop's K sequential [K, K+1] row updates is a tiny op
    paying a per-op floor that only a batch axis amortizes.  (Not yet
    measured on the H100 — ROADMAP A3.)  Both solvers reach
    the identical optimum (tests/test_nn_omp.py).
    """
    import functools

    import jax

    from slam_process_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    from slam_process_tpu.utils.precision import jit_highest

    return jit_highest(functools.partial(nn_omp_jax, cfg=cfg, keep_rule=keep_rule,
                                         stop_nonpositive=stop_nonpositive,
                                         nnls_solver="lu"))


def run_nn_omp(
    dictionary: BeamDictionary,
    rss_matrix: np.ndarray,
    cfg: OmpConfig = OmpConfig(),
    keep_rule: str = "ratio",
    stop_nonpositive: bool = True,
    engine: str = "host",
    logger=None,
) -> OmpPaths:
    """One entry point for every NN-OMP flavor: float64 host oracle or the
    cached jitted device path (used by all v1/v1-3..v1-7 registry entries
    and the fusion LoS stage)."""
    if engine == "device":
        import jax
        import jax.numpy as jnp

        fn = _jitted_nn_omp(cfg, keep_rule, stop_nonpositive)
        out = fn(jnp.asarray(dictionary.phi_rx, jnp.float32),
                 jnp.asarray(dictionary.phi_tx, jnp.float32),
                 jnp.asarray(dictionary.aoa_grid, jnp.float32),
                 jnp.asarray(dictionary.aod_grid, jnp.float32),
                 jnp.asarray(rss_matrix, jnp.float32))
        return jax.device_get(out)   # one batched pytree transfer
    return nn_omp_np(dictionary, rss_matrix, cfg, keep_rule=keep_rule,
                     stop_nonpositive=stop_nonpositive, logger=logger)


def nn_omp_batch_jax(
    phi_rx,            # jnp [U, Ga]
    phi_tx,            # jnp [B, Gd]
    aoa_grid,          # jnp [Ga]
    aod_grid,          # jnp [Gd]
    mats,              # jnp [S, U, B] — S scenes sharing one dictionary
    cfg: OmpConfig = OmpConfig(),
    keep_rule: str = "ratio",
    stop_nonpositive: bool = True,
    nnls_solver: str = "auto",
):
    """NN-OMP over S scenes sharing one dictionary, batched-GEMM form.

    ``jax.vmap(nn_omp_jax)`` is the obvious formulation, but XLA lowers the
    vmapped correlation chain to S small per-lane GEMMs with a broadcast
    operand, far below what the same FLOPs reach as one large
    contraction.  Here each selection iteration
    computes ALL scenes' correlations as two whole-batch contractions
    ([Ga,U]x[U,S*B] then [S*Ga,B]x[B,Gd]), and only the tiny K-sized refit
    work stays per-scene (vmapped NNLS — measured free next to the GEMMs).

    Per-scene arithmetic is the same algorithm as :func:`nn_omp_jax`
    (duplicate-atom stop, stop_nonpositive, NNLS refit on zero-padded
    atom slots); returns OmpPaths of [S, ...] arrays.
    """
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.ops.nnls import nnls_gram

    K = cfg.max_paths
    S, U, B = mats.shape
    Ga = phi_rx.shape[1]
    Gd = phi_tx.shape[1]
    Y = mats.reshape(S, U * B).astype(jnp.float32)
    slots = jnp.arange(K)

    def body(carry, _):
        R, sel_r, sel_t, coeffs, passive, nsel, done = carry
        # Whole-batch correlation: two large GEMMs instead of S small ones.
        t1 = jnp.einsum("ug,sub->sgb", phi_rx, R.reshape(S, U, B))
        corr = jnp.einsum("sgb,bd->sgd", t1, phi_tx).reshape(S, Ga * Gd)
        max_corr = jnp.max(corr, axis=1)
        flat_idx = jnp.argmax(corr, axis=1)
        i_r = (flat_idx // Gd).astype(jnp.int32)
        i_t = (flat_idx % Gd).astype(jnp.int32)

        dup = jnp.any((sel_r == i_r[:, None]) & (sel_t == i_t[:, None])
                      & (slots[None, :] < nsel[:, None]), axis=1)
        stop = done | dup | (stop_nonpositive & (max_corr <= 0))

        upd = (slots[None, :] == nsel[:, None]) & ~stop[:, None]
        sel_r2 = jnp.where(upd, i_r[:, None], sel_r)
        sel_t2 = jnp.where(upd, i_t[:, None], sel_t)
        nsel2 = jnp.where(stop, nsel, nsel + 1)

        active = (slots[None, :] < nsel2[:, None]).astype(jnp.float32)
        cols_rx = jnp.take_along_axis(
            phi_rx[None], sel_r2[:, None, :], axis=2) * active[:, None, :]
        cols_tx = jnp.take_along_axis(
            phi_tx[None], sel_t2[:, None, :], axis=2) * active[:, None, :]
        A = (cols_rx[:, :, None, :] * cols_tx[:, None, :, :]).reshape(
            S, U * B, K)
        G = jnp.einsum("smk,sml->skl", A, A)
        b = jnp.einsum("smk,sm->sk", A, Y)
        # Warm-started Lawson-Hanson (see nn_omp_gram_batch_jax).
        coeffs2, passive2 = jax.vmap(
            lambda g, v, xw, pw: nnls_gram(
                g, v, max_outer=cfg.nnls_max_iter, solver=nnls_solver,
                x0=xw, P0=pw))(G, b, coeffs, passive)
        R2 = Y - jnp.einsum("smk,sk->sm", A, coeffs2)

        coeffs_out = jnp.where(stop[:, None], coeffs, coeffs2)
        passive_out = jnp.where(stop[:, None], passive, passive2)
        R_out = jnp.where(stop[:, None], R, R2)
        return (R_out, sel_r2, sel_t2, coeffs_out, passive_out, nsel2,
                stop), None

    init = (
        Y,
        jnp.zeros((S, K), jnp.int32),
        jnp.zeros((S, K), jnp.int32),
        jnp.zeros((S, K), jnp.float32),
        jnp.zeros((S, K), bool),
        jnp.zeros(S, jnp.int32),
        jnp.zeros(S, bool),
    )
    (R, sel_r, sel_t, coeffs, _, nsel, _), _ = jax.lax.scan(
        body, init, None, length=K)

    in_sel = slots[None, :] < nsel[:, None]
    max_coeff = jnp.max(jnp.where(in_sel, coeffs, -jnp.inf), axis=1)
    if keep_rule == "ratio":
        valid = in_sel & (coeffs > max_coeff[:, None] * cfg.min_power_ratio)
    else:
        valid = in_sel & (coeffs > 0)
    return OmpPaths(
        aoa=aoa_grid[sel_r],
        aod=aod_grid[sel_t],
        power=coeffs,
        valid=valid,
        n_iters=nsel,
        aoa_idx=jnp.where(in_sel, sel_r, -1),
        aod_idx=jnp.where(in_sel, sel_t, -1),
    )


def nn_omp_gram_batch_jax(
    phi_rx,            # jnp [U, Ga]
    phi_tx,            # jnp [B, Gd]
    aoa_grid,          # jnp [Ga]
    aod_grid,          # jnp [Gd]
    mats,              # jnp [S, U, B]
    cfg: OmpConfig = OmpConfig(),
    keep_rule: str = "ratio",
    stop_nonpositive: bool = True,
    nnls_solver: str = "auto",
):
    """Gram-domain NN-OMP: the heavy correlation chain runs ONCE, not K times.

    Identity: with selected atoms a_k = outer(phi_rx[:, r_k], phi_tx[:, t_k])
    and residual R = Y - sum_k c_k a_k, the correlation surface is

        Phi_rx^T R Phi_tx = corr_Y - sum_k c_k Grx[:, r_k] (x) Gtx[:, t_k]

    where Grx = Phi_rx^T Phi_rx and Gtx = Phi_tx^T Phi_tx are the
    dictionary Grams (computed once per dictionary).  Likewise the NNLS
    system is pure gathers: G_kl = Grx[r_k, r_l] * Gtx[t_k, t_l],
    b_k = corr_Y[r_k, t_k].  So each selection iteration costs a rank-K
    [Ga, Gd] elementwise update + argmax instead of the two-GEMM chain —
    the chain's FLOPs are paid once instead of K times (3x fewer at K=3,
    ~15x at K=20).  Algebraically identical to :func:`nn_omp_batch_jax`;
    floating-point rounding differs, so parity with the float64 oracle is
    asserted by the same selection-sequence tests.
    """
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.ops.nnls import nnls_gram

    K = cfg.max_paths
    S, U, B = mats.shape
    Ga = phi_rx.shape[1]
    Gd = phi_tx.shape[1]
    Y = mats.astype(jnp.float32)
    slots = jnp.arange(K)

    grx = phi_rx.T @ phi_rx                      # [Ga, Ga] dictionary Gram
    gtx = phi_tx.T @ phi_tx                      # [Gd, Gd]
    corr_y = jnp.einsum("ug,sub,bd->sgd", phi_rx, Y, phi_tx)  # ONCE

    def body(carry, _):
        sel_r, sel_t, coeffs, passive, nsel, done = carry
        # Residual correlation = corr_y minus the selected atoms' rank-K
        # Gram outer products (zero for inactive slots via zero coeffs).
        active_c = coeffs * (slots[None, :] < nsel[:, None])   # [S, K]
        # Axis-wise argmax with NO materialized residual surface: the
        # subtract has exactly ONE consumer (the row-max reduce), so XLA
        # fuses it into the reduction and the iteration's only large
        # traffic is ONE read of corr_y.  The old flatten+argmax form
        # paid a re-tiling reshape COPY of the [S, Ga, Gd] surface plus
        # two reduce reads.
        # Tie-breaking matches the flat argmax exactly: smallest g with
        # the global max, then smallest d within that row.  The winning
        # ROW is recomputed from corr_y + the rank-K update at g = i_r
        # (a [S, Gd] expression) — same arithmetic, so any difference
        # from the fused reduction's internal values is sub-ulp
        # reassociation, the same robustness class as f32-vs-f64
        # selection parity the whole estimator already rests on.
        grs = grx.T[sel_r]                                     # [S, K, Ga]
        gts = gtx.T[sel_t]                                     # [S, K, Gd]
        resid = corr_y
        for k in range(K):   # static unroll: pure broadcasts, no dot op
            resid = resid - (active_c[:, k, None, None]
                             * grs[:, k, :, None] * gts[:, k, None, :])
        m1 = jnp.max(resid, axis=2)                            # [S, Ga]
        i_r = jnp.argmax(m1, axis=1).astype(jnp.int32)         # [S]
        max_corr = jnp.take_along_axis(m1, i_r[:, None], axis=1)[:, 0]
        g_at = jnp.take_along_axis(grs, i_r[:, None, None],
                                   axis=2)[:, :, 0]            # [S, K]
        row = corr_y[jnp.arange(S), i_r]
        for k in range(K):
            row = row - (active_c[:, k, None] * g_at[:, k, None]
                         * gts[:, k, :])
        i_t = jnp.argmax(row, axis=1).astype(jnp.int32)        # [S]

        dup = jnp.any((sel_r == i_r[:, None]) & (sel_t == i_t[:, None])
                      & (slots[None, :] < nsel[:, None]), axis=1)
        stop = done | dup | (stop_nonpositive & (max_corr <= 0))

        upd = (slots[None, :] == nsel[:, None]) & ~stop[:, None]
        sel_r2 = jnp.where(upd, i_r[:, None], sel_r)
        sel_t2 = jnp.where(upd, i_t[:, None], sel_t)
        nsel2 = jnp.where(stop, nsel, nsel + 1)

        # NNLS on the separable Gram system — all gathers, no [U*B, K] A.
        active = (slots[None, :] < nsel2[:, None]).astype(jnp.float32)
        Gk = (grx[sel_r2[:, :, None], sel_r2[:, None, :]]
              * gtx[sel_t2[:, :, None], sel_t2[:, None, :]])
        Gk = Gk * active[:, :, None] * active[:, None, :]
        bk = corr_y[jnp.arange(S)[:, None], sel_r2, sel_t2] * active
        # Warm-started NNLS: old Gram rows/cols and b entries are
        # unchanged when one atom joins, so the previous (coeffs,
        # passive) is a valid Lawson-Hanson resume point — ~2 outer
        # iterations per refit instead of re-adding all nsel atoms.
        coeffs2, passive2 = jax.vmap(
            lambda g, v, xw, pw: nnls_gram(
                g, v, max_outer=cfg.nnls_max_iter, solver=nnls_solver,
                x0=xw, P0=pw))(Gk, bk, coeffs, passive)

        coeffs_out = jnp.where(stop[:, None], coeffs, coeffs2)
        passive_out = jnp.where(stop[:, None], passive, passive2)
        return (sel_r2, sel_t2, coeffs_out, passive_out, nsel2, stop), None

    init = (
        jnp.zeros((S, K), jnp.int32),
        jnp.zeros((S, K), jnp.int32),
        jnp.zeros((S, K), jnp.float32),
        jnp.zeros((S, K), bool),
        jnp.zeros(S, jnp.int32),
        jnp.zeros(S, bool),
    )
    (sel_r, sel_t, coeffs, _, nsel, _), _ = jax.lax.scan(body, init, None,
                                                         length=K)

    in_sel = slots[None, :] < nsel[:, None]
    max_coeff = jnp.max(jnp.where(in_sel, coeffs, -jnp.inf), axis=1)
    if keep_rule == "ratio":
        valid = in_sel & (coeffs > max_coeff[:, None] * cfg.min_power_ratio)
    else:
        valid = in_sel & (coeffs > 0)
    return OmpPaths(
        aoa=aoa_grid[sel_r],
        aod=aod_grid[sel_t],
        power=coeffs,
        valid=valid,
        n_iters=nsel,
        aoa_idx=jnp.where(in_sel, sel_r, -1),
        aod_idx=jnp.where(in_sel, sel_t, -1),
    )


def nn_omp_jax(
    phi_rx,            # jnp [U, Ga]
    phi_tx,            # jnp [B, Gd]
    aoa_grid,          # jnp [Ga]
    aod_grid,          # jnp [Gd]
    rss_matrix,        # jnp [U, B]
    cfg: OmpConfig = OmpConfig(),
    keep_rule: str = "ratio",
    stop_nonpositive: bool = True,
    nnls_solver: str = "auto",
):
    """Jittable NN-OMP with static max_paths slots.

    Returns OmpPaths of jnp arrays.  The NNLS refit runs on the Gram system
    of the selected outer-product atoms; unselected slots hold zero columns
    and are provably never activated by the solver.
    """
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.ops.nnls import nnls_gram

    K = cfg.max_paths
    U, Ga = phi_rx.shape
    B, Gd = phi_tx.shape
    y = rss_matrix.reshape(-1)

    def body(carry, _):
        residual, sel_r, sel_t, coeffs, passive, nsel, done = carry
        corr = phi_rx.T @ residual.reshape(U, B) @ phi_tx
        max_corr = jnp.max(corr)
        flat_idx = jnp.argmax(corr)
        i_r, i_t = flat_idx // Gd, flat_idx % Gd

        dup = jnp.any((sel_r == i_r) & (sel_t == i_t) &
                      (jnp.arange(K) < nsel))
        stop = done | dup | (stop_nonpositive & (max_corr <= 0))

        sel_r2 = jnp.where(stop, sel_r, sel_r.at[nsel].set(i_r))
        sel_t2 = jnp.where(stop, sel_t, sel_t.at[nsel].set(i_t))
        nsel2 = jnp.where(stop, nsel, nsel + 1)

        # Atom matrix [U*B, K]: zero columns for unselected slots.
        active = jnp.arange(K) < nsel2
        cols_rx = phi_rx[:, sel_r2] * active[None, :]       # [U, K]
        cols_tx = phi_tx[:, sel_t2] * active[None, :]       # [B, K]
        A = (cols_rx[:, None, :] * cols_tx[None, :, :]).reshape(U * B, K)
        G = A.T @ A
        b = A.T @ y
        # Warm-started Lawson-Hanson (see nn_omp_gram_batch_jax).
        coeffs2, passive2 = nnls_gram(G, b, max_outer=cfg.nnls_max_iter,
                                      solver=nnls_solver, x0=coeffs,
                                      P0=passive)
        residual2 = y - A @ coeffs2

        coeffs_out = jnp.where(stop, coeffs, coeffs2)
        passive_out = jnp.where(stop, passive, passive2)
        residual_out = jnp.where(stop, residual, residual2)
        return (residual_out, sel_r2, sel_t2, coeffs_out, passive_out,
                nsel2, stop), None

    init = (
        y,
        jnp.zeros(K, dtype=jnp.int32),
        jnp.zeros(K, dtype=jnp.int32),
        jnp.zeros(K, dtype=y.dtype),
        jnp.zeros(K, dtype=bool),
        jnp.int32(0),
        jnp.bool_(False),
    )
    (residual, sel_r, sel_t, coeffs, _, nsel, _), _ = jax.lax.scan(
        body, init, None, length=K
    )

    slots = jnp.arange(K)
    in_sel = slots < nsel
    max_coeff = jnp.max(jnp.where(in_sel, coeffs, -jnp.inf))
    if keep_rule == "ratio":
        valid = in_sel & (coeffs > max_coeff * cfg.min_power_ratio)
    else:
        valid = in_sel & (coeffs > 0)
    return OmpPaths(
        aoa=aoa_grid[sel_r],
        aod=aod_grid[sel_t],
        power=coeffs,
        valid=valid,
        n_iters=nsel,
        aoa_idx=jnp.where(in_sel, sel_r, -1),
        aod_idx=jnp.where(in_sel, sel_t, -1),
    )
