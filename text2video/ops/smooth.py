"""Temporal smoothing with mouth re-pinning.

The reference smooths face (210-dim) and pose (75-dim) tracks with an
asymmetric inverse-distance window ``s in range(-smooth_width, smooth_width)``
(note: excludes +smooth_width) weighted ``1/(|s|+1)``, then *re-pins the
mouth*: the original (un-smoothed) mouth points 48-67 are shifted by the
difference of smoothed vs original mouth centers (average of points 48-59)
and pasted over the smoothed face, so lip articulation is not blurred
(reference: interp_landmarks_motion_phoneme_VidTIMIT_smooth.py:230-258,
mouth_center/mouth_shift at :104-114).

Crucial quirk: the reference mutates its frame list *in place* while
iterating (:257-258), so neighbors at negative offsets contribute their
already-smoothed, mouth-re-pinned values — the filter is recursive (IIR),
not a plain convolution. Both implementations here preserve that:
``smooth_host`` is the bit-exact float64 sequential loop; ``smooth_device``
is a float32 ``lax.scan`` carrying the last ``smooth_width`` smoothed frames.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

MOUTH_CENTER_LO, MOUTH_CENTER_HI = 48, 60  # points averaged for the center
MOUTH_LO, MOUTH_HI = 48, 68  # points shifted & re-pinned


def smooth_host(
    face: np.ndarray, pose: np.ndarray, smooth_width: int = 4
) -> Tuple[np.ndarray, np.ndarray]:
    """(face [T,210], pose [T,75]) float64 -> smoothed copies, bit-exact.

    ``wf``/``wp`` play the role of the reference's in-place-mutated
    ``jsonlist``: rows before the current index already hold smoothed
    values when the window reads them.
    """
    T = face.shape[0]
    wf = face.copy()
    wp = pose.copy()
    for idx in range(T):
        sum_fc = np.zeros((1, 210), dtype=np.float64)
        sum_ps = np.zeros((1, 75), dtype=np.float64)
        sum_w = 0.0
        for s in range(-smooth_width, smooth_width):
            sidx = s + idx
            if 0 <= sidx < T:
                wt = 1.0 / (abs(s) + 1.0)
                sum_fc += wf[sidx] * wt
                sum_ps += wp[sidx] * wt
                sum_w += wt
        ave_fc = sum_fc / sum_w
        ave_ps = sum_ps / sum_w

        orig_fc = wf[idx].copy()
        c_t = np.average(
            ave_fc.reshape(70, 3)[MOUTH_CENTER_LO:MOUTH_CENTER_HI, :], axis=0
        )
        c_s = np.average(
            orig_fc.reshape(70, 3)[MOUTH_CENTER_LO:MOUTH_CENTER_HI, :], axis=0
        )
        off = c_t - c_s
        for i in range(MOUTH_LO, MOUTH_HI):
            orig_fc[i * 3] = orig_fc[i * 3] + off[0]
            orig_fc[i * 3 + 1] = orig_fc[i * 3 + 1] + off[1]
        ave_fc[0, MOUTH_LO * 3 : MOUTH_HI * 3] = orig_fc[
            MOUTH_LO * 3 : MOUTH_HI * 3
        ]
        wf[idx] = ave_fc[0]
        wp[idx] = ave_ps[0]
    return wf, wp


def smooth_device(face, pose, smooth_width: int = 4):
    """Float32 recursive smoothing as a ``lax.scan`` over frames.

    The carry holds the last ``smooth_width`` smoothed frames (the IIR
    feedback); future frames are read from static shifts of the input. The
    per-step work is a handful of 285-float FMAs — latency-bound but tiny,
    and fused into one compiled program with the interpolation gather that
    feeds it.
    """
    import jax
    import jax.numpy as jnp

    sw = smooth_width
    T = face.shape[0]
    D_F, D_P = face.shape[1], pose.shape[1]

    # Forward windows x[t + s] for s = 0..sw-1, padded with zeros past the
    # end, plus validity masks. Shapes [T, sw, D].
    def fwd_windows(x):
        cols = [
            jnp.pad(x[s:], ((0, s), (0, 0))) for s in range(0, sw)
        ]
        return jnp.stack(cols, axis=1)

    t_ar = jnp.arange(T)[:, None]
    s_fwd = jnp.arange(0, sw)[None, :]
    fwd_valid = (t_ar + s_fwd < T).astype(face.dtype)  # [T, sw]
    w_fwd = (1.0 / (jnp.abs(s_fwd) + 1.0)).astype(face.dtype) * fwd_valid
    s_bwd = jnp.arange(-sw, 0)[None, :]
    bwd_valid = (t_ar + s_bwd >= 0).astype(face.dtype)
    w_bwd = (1.0 / (jnp.abs(s_bwd) + 1.0)).astype(face.dtype) * bwd_valid

    face_w = fwd_windows(face)  # [T, sw, 210]
    pose_w = fwd_windows(pose)  # [T, sw, 75]

    def repin(ave_fc, orig_fc):
        ave3 = ave_fc.reshape(70, 3)
        orig3 = orig_fc.reshape(70, 3)
        c_t = jnp.mean(ave3[MOUTH_CENTER_LO:MOUTH_CENTER_HI, :], axis=0)
        c_s = jnp.mean(orig3[MOUTH_CENTER_LO:MOUTH_CENTER_HI, :], axis=0)
        off = (c_t - c_s).at[2].set(0.0)
        shifted = orig3[MOUTH_LO:MOUTH_HI, :] + off[None, :]
        return ave3.at[MOUTH_LO:MOUTH_HI, :].set(shifted).reshape(-1)

    def step(carry, inputs):
        prev_f, prev_p = carry  # [sw, 210], [sw, 75]: smoothed t-sw..t-1
        fw, pw, wgt_f, wgt_b, cur_f = inputs
        sum_w = jnp.sum(wgt_f) + jnp.sum(wgt_b)
        sum_fc = wgt_b @ prev_f + wgt_f @ fw
        sum_ps = wgt_b @ prev_p + wgt_f @ pw
        ave_fc = sum_fc / sum_w
        ave_ps = sum_ps / sum_w
        ave_fc = repin(ave_fc, cur_f)
        new_prev_f = jnp.concatenate([prev_f[1:], ave_fc[None]], axis=0)
        new_prev_p = jnp.concatenate([prev_p[1:], ave_ps[None]], axis=0)
        return (new_prev_f, new_prev_p), (ave_fc, ave_ps)

    init = (
        jnp.zeros((sw, D_F), dtype=face.dtype),
        jnp.zeros((sw, D_P), dtype=pose.dtype),
    )
    (_, _), (out_f, out_p) = jax.lax.scan(
        step, init, (face_w, pose_w, w_fwd, w_bwd, face)
    )
    return out_f, out_p


def smooth_device_jit(face, pose, smooth_width: int = 4):
    import jax

    return jax.jit(
        lambda f, p: smooth_device(f, p, smooth_width)
    )(face, pose)


def smooth_recursive_sharded(
    face, pose, mesh, smooth_width: int = 4, t_valid: int = None,
    warmup: int = 128,
):
    """EXACT recursive (IIR) smoothing with the time axis sharded over
    the mesh's "data" axis — byte-equal to ``smooth_host`` on every
    valid frame (tests/test_smooth_sharded.py).

    The reference's mutate-while-iterating recursion (module docstring)
    seems to force a T-step sequential chain, but its feedback is a
    CONTRACTION: the error dynamics e_t = sum_s (w_{-s}/W) e_{t-s} form
    an AR(4) system with coefficients (1/2, 1/3, 1/4, 1/5)/3.3667 whose
    companion-matrix spectral radius is ~0.67. So each shard re-derives
    its carry exactly by warm-starting the recursion ``warmup`` frames
    before its block with a zero history: the init error decays as
    rho^k, and after 128 frames 500 px * 0.67^128 ≈ 4e-20 — six orders
    of magnitude below half an ulp of a float64 pixel coordinate, so
    every rounded f64 intermediate is bit-identical to the sequential
    pass (warmup=64 measurably was NOT enough: residuals ~1e-9 showed
    through). Shards whose window is clamped at t=0 run the true
    recursion from frame 0 and are exact by construction, warm-up
    aside.

    All shards run their (warmup + T/n)-step scans CONCURRENTLY — the
    parallel-prefix trick for contracting IIR filters, here with zero
    communication (the inputs are 285 floats/frame; replicating them is
    cheaper than any halo choreography). Arithmetic mirrors
    ``smooth_host`` operation-for-operation in float64 (ordered
    window accumulation s = -sw..sw-1, ordered 12-point mouth-center
    means), so equality is bitwise, not approximate.

    face [T, 210], pose [T, 75]; T must divide by the data-axis size.
    t_valid: true utterance length when the tail is padding. Returns
    float64 arrays matching ``smooth_host`` on the valid prefix.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map

    sw = smooth_width
    n = mesh.shape["data"]
    T = face.shape[0]
    if T % n != 0:
        raise ValueError(f"T={T} must divide over {n} shards")
    tl = T // n
    t_valid = T if t_valid is None else t_valid
    d_f, d_p = face.shape[1], pose.shape[1]

    with jax.enable_x64():
        # Front-pad with `warmup` zero rows so every shard's scan window
        # is rows [idx*tl, idx*tl + warmup + tl) of the padded array;
        # global frame index of padded row r is r - warmup.
        face_ext = np.pad(
            np.asarray(face, np.float64), ((warmup, 0), (0, 0))
        )
        pose_ext = np.pad(
            np.asarray(pose, np.float64), ((warmup, 0), (0, 0))
        )
        wlen = warmup + tl

        def local(face_all, pose_all):
            idx = jax.lax.axis_index("data")
            start = idx * tl
            zero = jnp.zeros((), start.dtype)
            fwin = jax.lax.dynamic_slice(
                face_all, (start, zero), (wlen, d_f)
            )
            pwin = jax.lax.dynamic_slice(
                pose_all, (start, zero), (wlen, d_p)
            )
            # Forward windows row r -> original frames t..t+sw-1 (zeros
            # past the end; masks zero their weights anyway).
            f_pad = jnp.pad(fwin, ((0, sw), (0, 0)))
            p_pad = jnp.pad(pwin, ((0, sw), (0, 0)))
            fwd_f = jnp.stack([f_pad[j : j + wlen] for j in range(sw)], 1)
            fwd_p = jnp.stack([p_pad[j : j + wlen] for j in range(sw)], 1)
            # But the LAST sw rows' forward frames live beyond this
            # shard's slice — refill them from the replicated array
            # (global padded row start + r + j).
            tail_rows = jnp.arange(wlen - sw, wlen)
            gidx = start + tail_rows[:, None] + jnp.arange(sw)[None, :]
            gidx = jnp.clip(gidx, 0, T + warmup - 1)
            fwd_f = fwd_f.at[wlen - sw :].set(face_all[gidx])
            fwd_p = fwd_p.at[wlen - sw :].set(pose_all[gidx])

            # Global frame index per window row, and per-offset weights
            # masked by 0 <= t+s < t_valid (invalid terms add exact 0.0,
            # preserving the valid-only ordered-sum bit pattern).
            t_glob = start + jnp.arange(wlen) - warmup  # [wlen]
            offs = jnp.arange(-sw, sw)  # [2sw], order -sw..sw-1
            valid = (
                (t_glob[:, None] + offs[None, :] >= 0)
                & (t_glob[:, None] + offs[None, :] < t_valid)
            ).astype(jnp.float64)
            w_all = (1.0 / (jnp.abs(offs) + 1.0)) * valid  # [wlen, 2sw]
            # Barrier the weights: they are compile-time constants, and
            # XLA rewrites division by a CONSTANT into multiply-by-
            # reciprocal (measured: jit(x/12.0) == x*(1/12.0) != numpy
            # true division on 35% of inputs). Opaque weights keep
            # sum/sum_w a true divide, bit-matching smooth_host.
            w_all = jax.lax.optimization_barrier(w_all)
            wb = w_all[:, :sw]  # s = -sw..-1
            wf = w_all[:, sw:]  # s = 0..sw-1
            n12 = MOUTH_CENTER_HI - MOUTH_CENTER_LO
            twelve = jax.lax.optimization_barrier(
                jnp.asarray(float(n12), jnp.float64)
            )

            def ordered_sum(rows):
                # Strict left-to-right accumulation. A plain unrolled
                # add chain is NOT enough: XLA reassociates it into a
                # balanced tree (measured — the jitted chain equals the
                # pairwise-tree sum bit-for-bit, and optimization
                # barriers do not stop it), but it never reassociates
                # across lax.scan iterations, so a scan carry pins
                # smooth_host's sequential order exactly.
                init = jax.lax.pcast(
                    jnp.zeros(rows.shape[1:], jnp.float64),
                    ("data",),
                    to="varying",
                )
                s, _ = jax.lax.scan(lambda c, r: (c + r, None), init, rows)
                return s

            def omean12(rows):  # ordered 12-point mean, mirrors
                # np.average's sequential axis-0 reduce (divisor is the
                # barrier'd `twelve` — see the weights comment)
                return ordered_sum(rows) / twelve

            def step(carry, xs):
                prev_f, prev_p = carry  # [sw, D]: smoothed t-sw..t-1
                ff, pp, wgt_b, wgt_f = xs
                # Window rows in smooth_host's s = -sw..sw-1 order:
                # backward half from the carry, forward from originals.
                vals_f = jnp.concatenate([prev_f, ff], axis=0)
                vals_p = jnp.concatenate([prev_p, pp], axis=0)
                w_row = jnp.concatenate([wgt_b, wgt_f], axis=0)
                sum_fc = ordered_sum(vals_f * w_row[:, None])
                sum_ps = ordered_sum(vals_p * w_row[:, None])
                sum_w = ordered_sum(w_row)
                # Warm-up rows at t <= -sw have every weight masked;
                # guard the 0/0 (their value is irrelevant but a NaN
                # would ride the carry into real frames).
                div = jnp.where(sum_w > 0.0, sum_w, 1.0)
                ave_fc = sum_fc / div
                ave_ps = sum_ps / div
                # Mouth re-pin (smooth_host lines: x/y shifted by the
                # center offset, z copied from the original).
                a3 = ave_fc.reshape(70, 3)
                o3 = ff[0].reshape(70, 3)  # s=0 row = original frame t
                c_t = omean12(a3[MOUTH_CENTER_LO:MOUTH_CENTER_HI])
                c_s = omean12(o3[MOUTH_CENTER_LO:MOUTH_CENTER_HI])
                off = (c_t - c_s).at[2].set(0.0)
                shifted = o3[MOUTH_LO:MOUTH_HI] + off[None, :]
                a3 = a3.at[MOUTH_LO:MOUTH_HI].set(shifted)
                ave_fc = a3.reshape(-1)
                new_f = jnp.concatenate([prev_f[1:], ave_fc[None]], 0)
                new_p = jnp.concatenate([prev_p[1:], ave_ps[None]], 0)
                return (new_f, new_p), (ave_fc, ave_ps)

            init = jax.lax.pcast(
                (
                    jnp.zeros((sw, d_f), jnp.float64),
                    jnp.zeros((sw, d_p), jnp.float64),
                ),
                ("data",),
                to="varying",
            )
            _, (out_f, out_p) = jax.lax.scan(
                step, init, (fwd_f, fwd_p, wb, wf)
            )
            return out_f[warmup:], out_p[warmup:]

        sharded = shard_map(
            local,
            mesh=mesh,
            in_specs=(P(), P()),
            out_specs=(P("data", None), P("data", None)),
        )
        out_f, out_p = jax.jit(sharded)(
            jnp.asarray(face_ext), jnp.asarray(pose_ext)
        )
        return np.asarray(out_f), np.asarray(out_p)


def smooth_fir_host(
    face: np.ndarray, pose: np.ndarray, smooth_width: int = 4
) -> Tuple[np.ndarray, np.ndarray]:
    """Non-recursive (FIR) variant: the window always reads ORIGINAL
    neighbor values. This is what the reference's loop would compute
    without its mutate-while-iterating quirk; it admits exact temporal
    sharding (see smooth_fir_sharded) because no cross-frame dependency
    chain exists. Mouth re-pin semantics are identical."""
    T = face.shape[0]
    out_f = np.empty_like(face)
    out_p = np.empty_like(pose)
    for idx in range(T):
        sum_fc = np.zeros(210, dtype=np.float64)
        sum_ps = np.zeros(75, dtype=np.float64)
        sum_w = 0.0
        for s in range(-smooth_width, smooth_width):
            sidx = s + idx
            if 0 <= sidx < T:
                wt = 1.0 / (abs(s) + 1.0)
                sum_fc += face[sidx] * wt
                sum_ps += pose[sidx] * wt
                sum_w += wt
        ave_fc = sum_fc / sum_w
        ave_ps = sum_ps / sum_w
        orig = face[idx]
        c_t = ave_fc.reshape(70, 3)[MOUTH_CENTER_LO:MOUTH_CENTER_HI].mean(0)
        c_s = orig.reshape(70, 3)[MOUTH_CENTER_LO:MOUTH_CENTER_HI].mean(0)
        off = c_t - c_s
        ave3 = ave_fc.reshape(70, 3).copy()
        ave3[MOUTH_LO:MOUTH_HI, 0] = orig.reshape(70, 3)[MOUTH_LO:MOUTH_HI, 0] + off[0]
        ave3[MOUTH_LO:MOUTH_HI, 1] = orig.reshape(70, 3)[MOUTH_LO:MOUTH_HI, 1] + off[1]
        ave3[MOUTH_LO:MOUTH_HI, 2] = orig.reshape(70, 3)[MOUTH_LO:MOUTH_HI, 2]
        out_f[idx] = ave3.reshape(-1)
        out_p[idx] = ave_ps
    return out_f, out_p


def smooth_fir_sharded(
    face, pose, mesh, smooth_width: int = 4, t_valid: int = None
):
    """FIR smoothing with the time axis sharded over the mesh's "data"
    axis: each device smooths its local frame block after a
    +-smooth_width halo exchange with its ring neighbors (``ppermute``)
    — the sharded-convolution-with-halo pattern from SURVEY.md §2.5 for
    utterances that span devices.

    face [T, 210], pose [T, 75] float32; T must divide by the data-axis
    size. t_valid: true utterance length when the tail is padding (the
    window mask treats frames >= t_valid as out of range, so padded rows
    never bleed into real frames). Returns smoothed arrays matching
    smooth_fir_host on the valid prefix.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map

    sw = smooth_width
    n = mesh.shape["data"]
    T = face.shape[0]
    if T % n != 0:
        raise ValueError(f"T={T} must divide over {n} shards")
    if T // n < sw:
        # The ring halo exchange moves exactly sw rows from each
        # neighbour; a shorter local block would silently truncate it.
        raise ValueError(
            f"per-shard block {T // n} < halo width {sw}; pad T to at "
            f"least {n * sw}"
        )
    t_valid = T if t_valid is None else t_valid

    def local(face_blk, pose_blk):
        # face_blk: [T/n, D]. Halo exchange around the ring; edge shards
        # receive garbage halos that the validity mask zeroes out.
        axis = "data"
        idx = jax.lax.axis_index(axis)
        tl = face_blk.shape[0]

        def with_halo(x):
            left = jax.lax.ppermute(
                x[-sw:], axis, [(i, (i + 1) % n) for i in range(n)]
            )
            right = jax.lax.ppermute(
                x[:sw], axis, [(i, (i - 1) % n) for i in range(n)]
            )
            return jnp.concatenate([left, x, right], axis=0)

        face_ext = with_halo(face_blk)  # [tl + 2sw, D]
        pose_ext = with_halo(pose_blk)

        t_global = idx * tl + jnp.arange(tl)  # [tl]
        offsets = jnp.arange(-sw, sw)  # [2sw]
        valid = (
            (t_global[:, None] + offsets[None, :] >= 0)
            & (t_global[:, None] + offsets[None, :] < t_valid)
        ).astype(jnp.float32)
        w = (1.0 / (jnp.abs(offsets) + 1.0))[None, :] * valid  # [tl, 2sw]

        # Gather windows from the halo'd block: row t reads ext[t + sw + s].
        rows = jnp.arange(tl)[:, None] + sw + offsets[None, :]  # [tl, 2sw]
        fwin = face_ext[rows]  # [tl, 2sw, D]
        pwin = pose_ext[rows]
        sum_w = jnp.sum(w, axis=1, keepdims=True)
        ave_f = jnp.einsum("ts,tsd->td", w, fwin) / sum_w
        ave_p = jnp.einsum("ts,tsd->td", w, pwin) / sum_w

        # Mouth re-pin (same formula as the sequential paths).
        a3 = ave_f.reshape(tl, 70, 3)
        o3 = face_blk.reshape(tl, 70, 3)
        c_t = a3[:, MOUTH_CENTER_LO:MOUTH_CENTER_HI].mean(axis=1)
        c_s = o3[:, MOUTH_CENTER_LO:MOUTH_CENTER_HI].mean(axis=1)
        off = (c_t - c_s).at[:, 2].set(0.0)
        shifted = o3[:, MOUTH_LO:MOUTH_HI] + off[:, None, :]
        a3 = a3.at[:, MOUTH_LO:MOUTH_HI].set(shifted)
        return a3.reshape(tl, -1), ave_p

    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("data", None), P("data", None)),
        out_specs=(P("data", None), P("data", None)),
    )
    face = jax.device_put(
        jnp.asarray(face, jnp.float32), NamedSharding(mesh, P("data", None))
    )
    pose = jax.device_put(
        jnp.asarray(pose, jnp.float32), NamedSharding(mesh, P("data", None))
    )
    return jax.jit(sharded)(face, pose)
