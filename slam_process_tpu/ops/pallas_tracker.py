"""Pallas (Triton) kernel for the streaming tracker's per-step sweep block.

The online-tracking slice of the device streaming step advances the
greedy global-NN tracker (models/tracking.make_track_sweep_step) over the
sweeps a window just closed.  As an XLA ``while_loop`` that is ~30 tiny
serialized ops per sweep (argmin over a [T, K] cost, one-element scatters,
ring writes): on a GPU every iteration costs kernel launches and a
predicate read, for T=8 tracks x K=3 paths of arithmetic.

This kernel runs the whole block in one launch: one program per stream
(``jax.vmap`` over streams adds the grid axis), a loop inside the program
over the closed sweeps, and the tracker carry (track positions, created
flags, track count) held in registers across iterations.  It writes the
[s1, T] output columns for the closed sweeps; rows at or past ``m_eff``
are left unwritten (the streaming ring overwrites them with later blocks
and never reads past its final closed-sweep count).

Exactness (same contract as models/tracking.track_paths_jax): within one
sweep the cost matrix is static — a matched track is masked out by
``assigned`` in the same iteration that moves its position, so its new
position never re-enters the cost — and the argmin tie-break (first flat
index, row-major) is ``min(where(cost == min(cost), flat_index, T*K))``.
Positions and powers are copied, never computed, so the columns equal the
loop's whenever the same (track, path) decisions are made.

Triton wants power-of-two block shapes; the wrapper pads T, K and s1 up
(padded tracks are never created, padded paths are invalid).
"""

from __future__ import annotations

import functools

__all__ = ["track_block_pallas"]


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _kernel(meff_ref, count_ref, pos_a_ref, pos_d_ref, created_ref,
            aoa_ref, aod_ref, pow_ref, val_ref,
            oa_ref, od_ref, op_ref, oo_ref,
            npos_a_ref, npos_d_ref, ncreated_ref, ncount_ref,
            *, gate2: float, k_n: int, t_n: int):
    import jax
    import jax.numpy as jnp

    tp = pos_a_ref.shape[0]
    kp = aoa_ref.shape[1]
    t_idx = jnp.arange(tp, dtype=jnp.int32)
    k_idx = jnp.arange(kp, dtype=jnp.int32)
    flat = t_idx[:, None] * kp + k_idx[None, :]                  # [T, K]
    before = k_idx[:, None] < k_idx[None, :]                     # [K, K]
    big = jnp.float32(jnp.inf)
    no_idx = jnp.int32(tp * kp)

    def sweep(i, carry):
        pos_a, pos_d, created, count = carry
        p_aoa = aoa_ref[i, :]                                    # [K]
        p_aod = aod_ref[i, :]
        p_pow = pow_ref[i, :]
        p_val = (val_ref[i, :] > 0) & (k_idx < k_n)
        da = pos_a[:, None] - p_aoa[None, :]                     # [T, K]
        dd = pos_d[:, None] - p_aod[None, :]
        cost = da * da + dd * dd

        assigned = jnp.zeros((tp,), jnp.int32)
        used = jnp.zeros((kp,), jnp.int32)
        obs = jnp.zeros((tp,), jnp.int32)
        opow = jnp.zeros((tp,), jnp.float32)
        for _ in range(k_n):
            m = (((created > 0) & (assigned == 0))[:, None]
                 & (p_val & (used == 0))[None, :])
            c = jnp.where(m, cost, big)
            mn = jnp.min(c)
            idx = jnp.min(jnp.where(c == mn, flat, no_idx))
            ok = mn <= gate2
            t_oh = (t_idx == idx // kp) & ok                     # [T]
            k_oh = (k_idx == idx % kp) & ok                      # [K]
            assigned = jnp.where(t_oh, 1, assigned)
            used = jnp.where(k_oh, 1, used)
            obs = jnp.where(t_oh, 1, obs)
            sel_a = jnp.sum(jnp.where(k_oh, p_aoa, 0.0))
            sel_d = jnp.sum(jnp.where(k_oh, p_aod, 0.0))
            sel_p = jnp.sum(jnp.where(k_oh, p_pow, 0.0))
            pos_a = jnp.where(t_oh, sel_a, pos_a)
            pos_d = jnp.where(t_oh, sel_d, pos_d)
            opow = jnp.where(t_oh, sel_p, opow)

        # New tracks for leftover valid paths, in path order: slot =
        # count + (leftover paths before this one).
        left = jnp.where(p_val & (used == 0), 1, 0)              # [K]
        rank = jnp.sum(jnp.where(before, left[:, None], 0), axis=0)
        slot = count + rank
        create = (left > 0) & (slot < t_n)
        oh = create[None, :] & (slot[None, :] == t_idx[:, None])  # [T, K]
        hit = jnp.sum(jnp.where(oh, 1, 0), axis=1) > 0            # [T]
        new_a = jnp.sum(jnp.where(oh, p_aoa[None, :], 0.0), axis=1)
        new_d = jnp.sum(jnp.where(oh, p_aod[None, :], 0.0), axis=1)
        new_p = jnp.sum(jnp.where(oh, p_pow[None, :], 0.0), axis=1)
        pos_a = jnp.where(hit, new_a, pos_a)
        pos_d = jnp.where(hit, new_d, pos_d)
        opow = jnp.where(hit, new_p, opow)
        created = jnp.where(hit, 1, created)
        obs = jnp.where(hit, 1, obs)
        count = count + jnp.sum(jnp.where(create, 1, 0))

        oa_ref[i, :] = pos_a
        od_ref[i, :] = pos_d
        op_ref[i, :] = opow
        oo_ref[i, :] = obs
        return pos_a, pos_d, created, count

    carry = (pos_a_ref[...], pos_d_ref[...], created_ref[...], count_ref[0])
    pos_a, pos_d, created, count = jax.lax.fori_loop(
        0, meff_ref[0], sweep, carry)
    npos_a_ref[...] = pos_a
    npos_d_ref[...] = pos_d
    ncreated_ref[...] = created
    ncount_ref[0] = count


def _call(aoa, aod, pw, val, meff, pos, created, count, *, gate_deg,
          interpret):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pltriton

    f32, i32 = jnp.float32, jnp.int32
    s1, k_n = aoa.shape
    t_n = pos.shape[0]
    sp, kp, tp = _pow2(s1), _pow2(k_n), _pow2(t_n)

    def rows(x, dtype):
        return jnp.pad(jnp.asarray(x, dtype), ((0, sp - s1), (0, kp - k_n)))

    def tracks(x, dtype):
        return jnp.pad(jnp.asarray(x, dtype), (0, tp - t_n))

    col = jax.ShapeDtypeStruct((sp, tp), f32)
    outs = pl.pallas_call(
        functools.partial(_kernel, gate2=float(gate_deg) ** 2, k_n=k_n,
                          t_n=t_n),
        out_shape=(col, col, col, jax.ShapeDtypeStruct((sp, tp), i32),
                   jax.ShapeDtypeStruct((tp,), f32),
                   jax.ShapeDtypeStruct((tp,), f32),
                   jax.ShapeDtypeStruct((tp,), i32),
                   jax.ShapeDtypeStruct((1,), i32)),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="track_block",
    )(
        jnp.minimum(jnp.asarray(meff, i32), s1).reshape(1),
        jnp.asarray(count, i32).reshape(1),
        tracks(pos[:, 0], f32), tracks(pos[:, 1], f32),
        tracks(created, i32),
        rows(aoa, f32), rows(aod, f32), rows(pw, f32), rows(val, i32),
    )
    oa, od, op, oo, npa, npd, ncr, ncount = outs
    new_pos = jnp.stack([npa[:t_n], npd[:t_n]], axis=1)
    return (oa[:s1, :t_n], od[:s1, :t_n], op[:s1, :t_n], oo[:s1, :t_n] > 0,
            new_pos, ncr[:t_n] > 0, ncount[0])


def track_block_pallas(aoa_l, aod_l, pow_l, val_l, m_eff, pos, created,
                       count, *, gate_deg: float, interpret: bool = False):
    """Advance the tracker over one step's closed-sweep block.

    Inputs: per-sweep path lanes ``aoa_l/aod_l/pow_l/val_l`` [s1, K]
    (lanes >= ``m_eff`` are ignored), the closed-sweep count ``m_eff``
    (traced i32), and the tracker carry (``pos`` [T, 2] f32, ``created``
    [T] bool, ``count`` i32).  Returns ``(col_aoa, col_aod, col_pow,
    col_obs, new_pos, new_created, new_count)`` where the ``col_*`` arrays
    are [s1, T] per-sweep output columns, equal per lane to
    ``track_sweep_step_np`` for lanes < m_eff and unspecified after.
    Traceable inside ``jit`` and ``vmap`` (one program per mapped lane).
    ``interpret=True`` runs the kernel in the Pallas interpreter (CPU).
    """
    return _call(aoa_l, aod_l, pow_l, val_l, m_eff, pos, created, count,
                 gate_deg=float(gate_deg), interpret=bool(interpret))
